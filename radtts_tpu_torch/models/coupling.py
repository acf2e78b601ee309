"""Affine coupling of the decoder flow steps: the WN (non-gated WaveNet)
parameter predictor, the scaling functions, the inverse (sampling) and the
forward (training, which also returns log_s). `factored=True` builds the WN
convs in their weight-normed training form (start, in_layers, res_skip, as
the JAX package's wn_init does)."""

import torch
import torch.nn.functional as F
from torch import nn

from radtts_tpu_torch.ops.conv import ConvNorm


def scaling_and_log_s(scale_unconstrained, scaling_fn):
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


class WN(nn.Module):
    def __init__(self, n_in, n_context, n_layers, n_channels, kernel_size=5,
                 factored=False):
        super().__init__()
        wn = factored
        self.start = ConvNorm(n_in + n_context, n_channels, 1, weight_norm=wn)
        self.end = ConvNorm(n_channels, 2 * n_in, 1, zero_init=True)
        self.in_layers = nn.ModuleList(
            ConvNorm(n_channels, n_channels, kernel_size, dilation=2 ** i,
                     weight_norm=wn)
            for i in range(n_layers))
        self.res_skip = nn.ModuleList(
            ConvNorm(n_channels, n_channels, 1, weight_norm=wn)
            for _ in range(n_layers))

    def forward(self, z, context, mask=None, affine_activation="softplus",
                use_partial_padding=True):
        act = F.softplus if affine_activation == "softplus" else torch.relu
        z = self.start(torch.cat([z, context], dim=-1))
        output = torch.zeros_like(z)
        for in_layer, res_skip in zip(self.in_layers, self.res_skip):
            z = act(in_layer(z, mask, use_partial_padding))
            output = output + act(res_skip(z))
        return self.end(output)


class AffineCoupling(nn.Module):
    def __init__(self, n_channels_total, n_context, n_layers,
                 affine_model="wavenet", n_hidden=1024, factored=False):
        super().__init__()
        if affine_model != "wavenet":
            raise NotImplementedError(f"{affine_model} affine model is not "
                                      "ported yet")
        self.n_half = n_channels_total // 2
        self.pred = WN(self.n_half, n_context, n_layers, n_hidden,
                       kernel_size=5, factored=factored)

    def forward(self, z, context, *, scaling_fn,
                affine_activation="softplus", mask=None,
                use_partial_padding=True):
        """(z with its second half s * z1 + b, log_s)
        (radtts_tpu/models/coupling.py:148-176)."""
        z0, z1 = z[..., :self.n_half], z[..., self.n_half:]
        affine_params = self.pred(z0, context, mask=mask,
                                  affine_activation=affine_activation,
                                  use_partial_padding=use_partial_padding)
        s, log_s = scaling_and_log_s(affine_params[..., :self.n_half],
                                     scaling_fn)
        z1 = s * z1 + affine_params[..., self.n_half:]
        return torch.cat([z0, z1], dim=-1), log_s

    def inverse(self, z, context, *, scaling_fn,
                affine_activation="softplus", mask=None,
                use_partial_padding=True):
        z0, z1 = z[..., :self.n_half], z[..., self.n_half:]
        affine_params = self.pred(z0, context, mask=mask,
                                  affine_activation=affine_activation,
                                  use_partial_padding=use_partial_padding)
        s, _ = scaling_and_log_s(affine_params[..., :self.n_half],
                                 scaling_fn)
        z1 = (z1 - affine_params[..., self.n_half:]) / s
        return torch.cat([z0, z1], dim=-1)
