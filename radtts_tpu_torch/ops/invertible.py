"""Invertible 1x1 "convolution" (channel-mixing matmul) of the flow steps,
LU-decomposed (matrix_decomposition "LUS"), inverse side.

W = P @ L @ U, L unit-lower-triangular, U upper with diagonal
upper_diag. Inference uses W^-1, computed once in fp32 at
load (`precompute_inverse`, the counterpart of the JAX package's
precompute_inverses) and applied as an fp32 matmul; the reference keeps
these products outside autocast.
"""

import numpy as np
import scipy.linalg
import torch
from torch import nn


def _random_orthonormal(c):
    q, _ = torch.linalg.qr(torch.randn(c, c))
    if torch.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


class InvConv1x1LUS(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.register_buffer("w_inv", torch.zeros(c, c))
        w = _random_orthonormal(c).double().numpy()
        p, lower, upper = scipy.linalg.lu(w)

        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32))

        self.register_buffer("p", f32(p))
        self.register_buffer("lower", f32(np.tril(lower, -1)))
        self.register_buffer("upper", f32(np.triu(upper, 1)))
        self.register_buffer("upper_diag", f32(np.diag(upper)))
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

    def inverse(self, x):
        """x: (B, T, C) -> x @ W^-T."""
        return torch.matmul(x, self.w_inv.T)
