"""Invertible 1x1 "convolution" (channel-mixing matmul) of the flow steps.

LU-decomposed (matrix_decomposition "LUS"): W = P @ L @ U, L
unit-lower-triangular, U upper with diagonal upper_diag. Inference uses
W^-1, computed once in fp32 at load (`precompute_inverse`, the counterpart
of the JAX package's precompute_inverses) and applied as an fp32 matmul;
the reference keeps these products outside autocast, and both are fp32
islands at every matmul precision (ops/precision.py).

The training form (`trainable=True`) holds lower, upper and upper_diag as
parameters and p as a buffer, and its forward returns (x W^T, log|det W|)
with log|det W| = sum(log|upper_diag|) (radtts_tpu/ops/invertible.py:60);
`folded()` gives the inference form. `InvConv1x1` is the plain-W
parametrization (log|det W| by slogdet), with the same two forms.
`scaling_and_log_s` is the affine couplings' elementwise scale.
"""

import numpy as np
import scipy.linalg
import torch
from torch import nn

from radtts_tpu_torch.ops import precision


def scaling_and_log_s(scale_unconstrained, scaling_fn):
    """(s, log s) of an affine coupling's raw scale by its scaling function
    (radtts_tpu/models/coupling.py), one function per channel if a list."""
    if isinstance(scaling_fn, (list, tuple)):
        parts = [scaling_and_log_s(scale_unconstrained[..., i:i + 1], fn)
                 for i, fn in enumerate(scaling_fn)]
        return (torch.cat([p[0] for p in parts], -1),
                torch.cat([p[1] for p in parts], -1))
    if scaling_fn == "translate":
        return (torch.ones_like(scale_unconstrained),
                torch.zeros_like(scale_unconstrained))
    if scaling_fn == "exp":
        return torch.exp(scale_unconstrained), scale_unconstrained
    if scaling_fn == "tanh":
        s = torch.tanh(scale_unconstrained) + 1.0 + 1e-6
        return s, torch.log(s)
    if scaling_fn == "sigmoid":
        s = torch.sigmoid(scale_unconstrained + 10.0) + 1e-6
        return s, torch.log(s)
    raise ValueError(f"scaling fn {scaling_fn} not supported")


def _random_orthonormal(c):
    q, _ = torch.linalg.qr(torch.randn(c, c))
    if torch.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


class InvConv1x1LUS(nn.Module):
    def __init__(self, c, trainable=False):
        super().__init__()
        self.trainable = trainable
        if not trainable:
            self.register_buffer("w_inv", torch.zeros(c, c))
        w = _random_orthonormal(c).double().numpy()
        p, lower, upper = scipy.linalg.lu(w)

        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32))

        self.register_buffer("p", f32(p))
        factors = {"lower": f32(np.tril(lower, -1)),
                   "upper": f32(np.triu(upper, 1)),
                   "upper_diag": f32(np.diag(upper))}
        for name, value in factors.items():
            if trainable:
                setattr(self, name, nn.Parameter(value))
            else:
                self.register_buffer(name, value)
        if not trainable:
            self.precompute_inverse()

    def weight(self):
        c = self.lower.shape[0]
        eye = torch.eye(c, dtype=self.lower.dtype, device=self.lower.device)
        L = torch.tril(self.lower, -1) + eye
        U = torch.triu(self.upper, 1) + torch.diag(self.upper_diag)
        return self.p @ (L @ U)

    @torch.no_grad()
    def precompute_inverse(self):
        self.w_inv.copy_(torch.linalg.inv(self.weight().float()))

    @precision.island
    def forward(self, x):
        """x: (B, T, C) -> (x @ W^T, log|det W|), in fp32 or wider."""
        dt = torch.promote_types(x.dtype, torch.float32)
        y = torch.matmul(x.to(dt), self.weight().to(dt).T)
        return y, torch.log(self.upper_diag.abs()).sum()

    @precision.island
    def inverse(self, x):
        """x: (B, T, C) -> x @ W^-T."""
        return torch.matmul(x, self.w_inv.T)

    @torch.no_grad()
    def folded(self):
        if not self.trainable:
            return self
        out = InvConv1x1LUS(self.p.shape[0])
        for name in ("p", "lower", "upper", "upper_diag"):
            getattr(out, name).copy_(getattr(self, name))
        out = out.to(self.p.device)
        out.precompute_inverse()
        return out


class InvConv1x1(nn.Module):
    """Plain W (radtts_tpu/ops/invertible.py:84-119): forward x W^T with
    log|det W| by slogdet, inverse x W^-T. The inference form
    (trainable=False) holds W as a buffer and W^-1 computed once
    (`precompute_inverse`, the JAX package's precompute_inverses); the
    training form holds W as a parameter and inverts it at each call."""

    def __init__(self, c, trainable=True):
        super().__init__()
        self.trainable = trainable
        w = _random_orthonormal(c)
        if trainable:
            self.w1x1 = nn.Parameter(w)
        else:
            self.register_buffer("w1x1", w)
            self.register_buffer("w_inv", torch.zeros(c, c))
            self.precompute_inverse()

    @torch.no_grad()
    def precompute_inverse(self):
        self.w_inv.copy_(torch.linalg.inv(self.w1x1.float()))

    @precision.island
    def forward(self, x):
        dt = torch.promote_types(x.dtype, torch.float32)
        w = self.w1x1.to(dt)
        return torch.matmul(x.to(dt), w.T), torch.linalg.slogdet(w)[1]

    @precision.island
    def inverse(self, x):
        w_inv = (torch.linalg.inv(self.w1x1) if self.trainable
                 else self.w_inv)
        return torch.matmul(x, w_inv.T)

    @torch.no_grad()
    def folded(self):
        if not self.trainable:
            return self
        out = InvConv1x1(self.w1x1.shape[0], trainable=False)
        out.w1x1.copy_(self.w1x1)
        out = out.to(self.w1x1.device)
        out.precompute_inverse()
        return out
