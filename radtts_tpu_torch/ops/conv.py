"""1-D convolutions, channels-last at the interface, with mask-renormalized
("partial") padding.

Weights are stored in torch's Conv1d layout (C_out, C_in, K); activations
enter and leave as (B, T, C) and are transposed to (B, C, T) for F.conv1d
inside. For inference, weight norm is collapsed once at load
(ops/fold_norms.py), so a conv holds only its effective weight. The
training form (`weight_norm=True`) holds the factorization weight_v, weight_g
as parameters and computes g * v / ||v|| in its forward, as the JAX
package's conv1d_apply does; `folded()` turns it into the inference form.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radtts_tpu_torch.ops.linear import GAINS


def effective_weight(params):
    """numpy: collapse a weight-normed conv {v, g} (v: (K, C_in, C_out),
    JAX layout) to its kernel, as the JAX package computes it."""
    if "v" in params:
        v = np.asarray(params["v"], np.float32)
        norm = np.sqrt(np.sum(v * v, axis=(0, 1), keepdims=True)) + 1e-30
        return np.asarray(params["g"], np.float32)[None, None, :] * v / norm
    return np.asarray(params["w"], np.float32)


def weight_norm_weight(v, g):
    """g * v / (||v|| + 1e-30), the norm over (C_in, K) of each output
    channel; v: (C_out, C_in, K), g: (C_out,)."""
    norm = v.square().sum((1, 2), keepdim=True).sqrt() + 1e-30
    return g[:, None, None] * v / norm


def conv1d(x, weight, bias=None, padding=0, dilation=1):
    """x: (B, T, C_in); weight: (C_out, C_in, K) -> (B, T', C_out).

    Mixed dtypes, as the JAX package's conv1d_apply takes them
    (radtts_tpu/ops/conv.py:60-92): inside an AMP region (x bf16) the
    weight and bias follow x, and the bias is added to the bf16 conv
    output; a bf16-stored weight (ops/fold_norms.py) with an fp32 x
    computes conv(bf16(x), w) with fp32 sums and an fp32 output, the JAX
    package's preferred_element_type=float32. torch's bf16 conv would
    round its output to bf16, so here both bf16 operands are widened to
    fp32 at use (their products are exact in fp32); the weight stays
    resident in bf16."""
    if weight.dtype == torch.bfloat16 and x.dtype == torch.float32:
        x = x.to(torch.bfloat16).float()
        weight = weight.float()
    elif x.dtype != weight.dtype:
        weight = weight.to(x.dtype)
    if x.dtype != torch.float32 and bias is not None:
        y = F.conv1d(x.transpose(1, 2), weight, None, padding=padding,
                     dilation=dilation)
        return y.transpose(1, 2) + bias.to(x.dtype)
    y = F.conv1d(x.transpose(1, 2), weight, bias, padding=padding,
                 dilation=dilation)
    return y.transpose(1, 2)


def partial_conv1d(x, weight, bias, padding, dilation, mask=None):
    """PartialConv1d: each window is renormalized by k / (#valid samples in
    it) and windows with no valid sample are zeroed. With mask None an
    all-ones mask is used, which still renormalizes the windows that
    overlap the zero padding at the borders."""
    k = weight.shape[-1]
    if mask is None:
        m = torch.ones(1, 1, x.shape[1], dtype=x.dtype, device=x.device)
        xm = x
    else:
        m = mask.to(x.dtype)[:, None, :]
        xm = x * m.transpose(1, 2)
    ones_k = torch.ones(1, 1, k, dtype=x.dtype, device=x.device)
    counts = F.conv1d(m, ones_k, padding=padding,
                      dilation=dilation).transpose(1, 2)       # (B, T, 1)
    update_mask = counts.clamp(0.0, 1.0)
    ratio = k / (counts + 1e-6) * update_mask
    raw = conv1d(xm, weight, None, padding, dilation)
    if bias is None:
        return raw * ratio
    return (raw * ratio + bias.to(x.dtype)) * update_mask


class ConvNorm(nn.Module):
    """Same-padded conv (reference ConvNorm) with optional partial padding;
    with a mask the output is re-zeroed past each length. weight_norm=True
    builds the training form, which holds weight_v and weight_g."""

    def __init__(self, in_ch, out_ch, kernel_size=1, dilation=1, bias=True,
                 gain_name="linear", zero_init=False, weight_norm=False):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.padding = dilation * (kernel_size - 1) // 2
        self.weight_norm = weight_norm
        weight = torch.empty(out_ch, in_ch, kernel_size)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        if zero_init:
            nn.init.zeros_(weight)
        else:
            nn.init.xavier_uniform_(weight, gain=GAINS[gain_name])
            if bias:
                bound = 1.0 / np.sqrt(in_ch * kernel_size)
                nn.init.uniform_(self.bias, -bound, bound)
        if weight_norm:
            self.weight_v = nn.Parameter(weight)
            self.weight_g = nn.Parameter(weight.square().sum((1, 2)).sqrt())
        else:
            self.weight = nn.Parameter(weight)

    def effective_weight(self):
        if self.weight_norm:
            return weight_norm_weight(self.weight_v, self.weight_g)
        return self.weight

    def forward(self, x, mask=None, use_partial_padding=False):
        weight = self.effective_weight()
        if use_partial_padding:
            y = partial_conv1d(x, weight, self.bias, self.padding,
                               self.dilation, mask)
        else:
            y = conv1d(x, weight, self.bias, self.padding, self.dilation)
        if mask is not None:
            y = y * mask.to(y.dtype)[:, :, None]
        return y

    @torch.no_grad()
    def folded(self):
        """The inference form: one weight, collapsed in numpy in the JAX
        package's layout (effective_weight), so that it equals the fold
        of the same JAX tree bit for bit."""
        if not self.weight_norm:
            return self
        v = self.weight_v.detach().cpu().numpy().transpose(2, 1, 0)
        w = effective_weight({"v": np.ascontiguousarray(v),
                              "g": self.weight_g.detach().cpu().numpy()})
        out = ConvNorm(self.weight_v.shape[1], self.weight_v.shape[0],
                       self.kernel_size, self.dilation,
                       bias=self.bias is not None)
        out.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            w.transpose(2, 1, 0))))
        if self.bias is not None:
            out.bias.copy_(self.bias)
        return out.to(self.weight_v.device)
