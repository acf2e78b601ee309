"""Masked instance norm: the text encoder's per-sample InstanceNorm1d over
valid frames, as one batched op; and the FFTransformer's LayerNorm."""

import torch
import torch.nn.functional as F
from torch import nn


def masked_instance_norm(x, mask, gamma, beta, eps=1e-5):
    """x: (B, T, C); mask: (B, T) validity. Stats over valid frames only;
    invalid frames are zeroed on output."""
    m = mask.to(x.dtype)[:, :, None]
    count = m.sum(1, keepdim=True)
    mean = (x * m).sum(1, keepdim=True) / count
    var = ((x - mean) ** 2 * m).sum(1, keepdim=True) / count
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * gamma + beta) * m


class InstanceNorm(nn.Module):
    def __init__(self, num_channels):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(num_channels))
        self.beta = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, mask):
        return masked_instance_norm(x, mask, self.gamma, self.beta)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis at eps 1e-5, with the JAX package's
    gamma and beta (radtts_tpu/ops/norms.py:33-37)."""

    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.gamma.to(x.dtype),
                            self.beta.to(x.dtype), self.eps)
