"""Text encoder: 3x [partial-padded conv -> masked InstanceNorm -> ReLU ->
dropout] -> masked BiLSTM. The whole module runs in fp32 (the reference
keeps it outside autocast), an fp32 island at every matmul precision
(ops/precision.py). Dropout (p = 0.5) runs only when the forward
is given a generator; `factored=True` builds the LSTM's training form."""

import torch
from torch import nn

from radtts_tpu_torch.ops import precision
from radtts_tpu_torch.ops.conv import ConvNorm
from radtts_tpu_torch.ops.dropout import dropout
from radtts_tpu_torch.ops.lstm import MaskedLSTM
from radtts_tpu_torch.ops.masking import sequence_mask
from radtts_tpu_torch.ops.norms import InstanceNorm

KERNEL_SIZE = 5
DROPOUT_P = 0.5


class Encoder(nn.Module):
    def __init__(self, encoder_embedding_dim=512, encoder_n_convolutions=3,
                 lstm_norm=None, factored=False):
        super().__init__()
        C = encoder_embedding_dim
        self.convs = nn.ModuleList(
            ConvNorm(C, C, KERNEL_SIZE, gain_name="relu")
            for _ in range(encoder_n_convolutions))
        self.norms = nn.ModuleList(
            InstanceNorm(C) for _ in range(encoder_n_convolutions))
        self.lstm = MaskedLSTM(C, C // 2, norm=lstm_norm, factored=factored)

    @precision.island
    def forward(self, x, in_lens=None, generator=None):
        """x: (B, N, C) text embeddings; in_lens None is the unmasked
        exact-length path; generator draws the training dropout."""
        B, N, _ = x.shape
        mask = None if in_lens is None else sequence_mask(in_lens, N)
        norm_mask = (torch.ones(B, N, dtype=torch.bool, device=x.device)
                     if mask is None else mask)
        for conv, norm in zip(self.convs, self.norms):
            x = conv(x, mask, use_partial_padding=True)
            x = dropout(torch.relu(norm(x, norm_mask)), DROPOUT_P, generator)
        return self.lstm(x, in_lens)
