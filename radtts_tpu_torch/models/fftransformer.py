"""The FastPitch-style feed-forward transformer of a DAP with
use_transformer (radtts_tpu/models/fftransformer.py): sinusoidal
positions, post-norm multi-head self-attention with a fused qkv and an
output projection without bias, and a conv feed-forward (conv, relu,
conv), each sub-layer followed by a residual LayerNorm and the frame mask,
then a dense layer.

The attention is plain torch.matmul and softmax in fp32 (the JAX package
computes it outside any Pallas kernel, with fp32 scores and padded keys
at -inf): not scaled_dot_product_attention, whose backend choice on the
card would change the rounding. The feed-forward's convs are ConvNorms, so
ops/fold_norms.py:store_conv_weights stores exactly them in bf16, as the
JAX package's fold_norms casts its 3-D kernels; qkv and o stay fp32. The
module lies in no AMP region (the JAX package's cast sites wrap
ConvLSTMLinear only).

Training draws dropout from an explicit generator (ops/dropout.py) in the
JAX package's order: the embedded input (dropemb, when above 0), then for
each layer the attention probabilities (dropatt), the attention output
and the feed-forward output (dropout).
"""

import math

import torch
from torch import nn

from radtts_tpu_torch.ops.conv import ConvNorm
from radtts_tpu_torch.ops.dropout import dropout
from radtts_tpu_torch.ops.linear import LinearNorm
from radtts_tpu_torch.ops.masking import sequence_mask
from radtts_tpu_torch.ops.norms import LayerNorm


def positional_embedding(T, demb, device=None):
    """(T, demb) fp32: [sin(t f_i), cos(t f_i)], f_i = 10000^(-2i/demb)."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0.0, demb, 2.0, device=device)
                                / demb))
    sinusoid = torch.arange(T, dtype=torch.float32,
                            device=device)[:, None] * inv_freq[None, :]
    return torch.cat([torch.sin(sinusoid), torch.cos(sinusoid)], dim=1)


class MultiHeadAttn(nn.Module):
    """Post-norm self-attention: LayerNorm(x + o(softmax(q k^T / sqrt(d))
    v)), keys past each length masked."""

    def __init__(self, n_head, d_model, d_head):
        super().__init__()
        self.n_head, self.d_head = n_head, d_head
        self.qkv = LinearNorm(d_model, 3 * n_head * d_head)
        self.o = LinearNorm(n_head * d_head, d_model, bias=False)
        nn.init.normal_(self.qkv.weight, std=math.sqrt(1.0 / d_model))
        nn.init.zeros_(self.qkv.bias)
        nn.init.normal_(self.o.weight, std=math.sqrt(1.0 / (n_head * d_head)))
        self.ln = LayerNorm(d_model)

    def forward(self, x, key_valid, p_drop=0.0, p_att=0.0, generator=None):
        B, T, _ = x.shape
        H, Dh = self.n_head, self.d_head
        q, k, v = (t.reshape(B, T, H, Dh).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        score = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(Dh))
        score = score.masked_fill(~key_valid[:, None, None, :],
                                  float("-inf"))
        prob = dropout(torch.softmax(score, dim=-1), p_att, generator)
        attn_vec = torch.matmul(prob, v).transpose(1, 2).reshape(B, T, H * Dh)
        out = dropout(self.o(attn_vec), p_drop, generator)
        return self.ln(x + out)


class ConvFF(nn.Module):
    """LayerNorm(x + conv(relu(conv(x)))), same-padded."""

    def __init__(self, d_model, d_inner, kernel_size):
        super().__init__()
        self.conv1 = ConvNorm(d_model, d_inner, kernel_size)
        self.conv2 = ConvNorm(d_inner, d_model, kernel_size)
        self.ln = LayerNorm(d_model)

    def forward(self, x, p_drop=0.0, generator=None):
        h = self.conv2(torch.relu(self.conv1(x)))
        return self.ln(x + dropout(h, p_drop, generator))


class FFTransformer(nn.Module):
    """fft_init's defaults, from a DAP's arch_hparams: in_dim, out_dim,
    n_layers and kernel_size are read, n_head, d_head, d_inner and the
    dropouts keep their defaults unless given, and every other key
    (n_channels, p_dropout, lstm_type, use_linear) is ignored, as there."""

    def __init__(self, in_dim, out_dim=1, n_layers=6, n_head=1, d_head=64,
                 d_inner=1024, kernel_size=3, dropout=0.1, dropatt=0.1,
                 dropemb=0.0, **_unused):
        super().__init__()
        self.in_dim = in_dim
        self.p_dropout, self.p_dropatt, self.p_dropemb = (dropout, dropatt,
                                                          dropemb)
        self.layers = nn.ModuleList(
            nn.ModuleDict({"attn": MultiHeadAttn(n_head, in_dim, d_head),
                           "ff": ConvFF(in_dim, d_inner, kernel_size)})
            for _ in range(n_layers))
        self.dense = LinearNorm(in_dim, out_dim)

    def forward(self, x, lens=None, generator=None):
        """x: (B, T, C) -> (B, T, out_dim); lens None: every frame valid.
        A generator draws the training dropout; None runs without it."""
        B, T, _ = x.shape
        mask = (torch.ones(B, T, dtype=torch.bool, device=x.device)
                if lens is None else sequence_mask(lens, T))
        mf = mask.to(x.dtype)[:, :, None]
        pos = positional_embedding(T, self.in_dim, x.device).to(x.dtype)
        out = dropout(x + pos[None] * mf, self.p_dropemb, generator)
        for layer in self.layers:
            out = layer["attn"](out, mask, self.p_dropout, self.p_dropatt,
                                generator) * mf
            out = layer["ff"](out, self.p_dropout, generator) * mf
        return self.dense(out)
