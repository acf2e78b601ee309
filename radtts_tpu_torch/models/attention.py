"""ConvAttention: Gaussian-isotropic text <-> mel alignment attention
(radtts_tpu/models/attention.py:18-65). Its projections are plain convs,
as the JAX package's conv_attention_init makes them (the reference's
ConvNorm without weight norm). The squared distance is expanded as
|q|^2 + |k|^2 - 2 q.k, so that the cross term is one batched matmul, in
fp32 (or wider)."""

import torch
import torch.nn.functional as F
from torch import nn

from radtts_tpu_torch.ops.conv import ConvNorm
from radtts_tpu_torch.ops.masking import sequence_mask

TEMPERATURE = 0.0005
EPS = 1e-8


class ConvAttention(nn.Module):
    def __init__(self, n_mel_channels=80, n_text_channels=512,
                 n_att_channels=80):
        super().__init__()
        self.key_proj = nn.ModuleList([
            ConvNorm(n_text_channels, n_text_channels * 2, 3,
                     gain_name="relu"),
            ConvNorm(n_text_channels * 2, n_att_channels, 1)])
        self.query_proj = nn.ModuleList([
            ConvNorm(n_mel_channels, n_mel_channels * 2, 3,
                     gain_name="relu"),
            ConvNorm(n_mel_channels * 2, n_mel_channels, 1),
            ConvNorm(n_mel_channels, n_att_channels, 1)])

    def forward(self, queries, keys, in_lens, attn_prior=None):
        """queries: (B, T_mel, n_mel) mel; keys: (B, T_text, C_text)
        embeddings. Returns (attn (B, T_mel, T_text), softmaxed over the
        text, attn_logprob)."""
        k = self.key_proj[0](keys)
        k = self.key_proj[1](torch.relu(k))
        q = self.query_proj[0](queries)
        q = self.query_proj[1](torch.relu(q))
        dt = torch.promote_types(q.dtype, torch.float32)
        q = self.query_proj[2](torch.relu(q)).to(dt)
        k = k.to(dt)
        q_sq = (q * q).sum(-1)[:, :, None]
        k_sq = (k * k).sum(-1)[:, None, :]
        cross = torch.bmm(q, k.transpose(1, 2))
        attn = -TEMPERATURE * (q_sq + k_sq - 2.0 * cross)
        if attn_prior is not None:
            attn = F.log_softmax(attn, dim=-1) + torch.log(attn_prior + EPS)
        attn_logprob = attn
        key_mask = sequence_mask(in_lens, keys.shape[1])
        attn = attn.masked_fill(~key_mask[:, None, :], float("-inf"))
        return torch.softmax(attn, dim=-1), attn_logprob
