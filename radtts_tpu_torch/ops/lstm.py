"""Masked (bi)LSTMs for inference, on torch.nn.LSTM with packed sequences.

Packed-sequence semantics are what the JAX package reproduces with masked
scans: the forward direction stops at each sequence's length, the backward
direction starts at its last valid frame, and outputs past the length are
zero. Gate order i, f, g, o and the two bias vectors match torch.

The recurrent weight is stored as its effective matrix. A spectral-normed
weight is collapsed once at load from its stored power-iteration vectors,
w / (u . (w v)) (`effective_hh`), never through
torch.nn.utils.spectral_norm, whose power iteration would move the weights.
"""

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from radtts_tpu_torch.ops.masking import sequence_mask


def effective_hh(hh):
    """numpy: collapse a recurrent-weight norm factorization ({w}, {wn_v,
    wn_g} or {sn_w, sn_u, sn_v}) to the effective (4H, H) matrix."""
    if "w" in hh:
        return np.asarray(hh["w"], np.float32)
    if "wn_v" in hh:
        v = np.asarray(hh["wn_v"], np.float32)
        norm = np.sqrt(np.sum(v * v, axis=1, keepdims=True)) + 1e-30
        return np.asarray(hh["wn_g"], np.float32)[:, None] * v / norm
    w = np.asarray(hh["sn_w"], np.float32)
    sigma = np.asarray(hh["sn_u"], np.float32) @ (
        w @ np.asarray(hh["sn_v"], np.float32))
    return w / sigma


class MaskedLSTM(nn.Module):
    """One- or two-directional single-layer LSTM over (B, T, C) with
    optional per-item lengths. Output (B, T, D*H), [fwd ; bwd]."""

    def __init__(self, input_size, hidden_size, bidirectional=True,
                 norm=None):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, batch_first=True,
                            bidirectional=bidirectional)
        self.norm = norm    # the factorization a checkpoint stores
        if norm == "spectral":
            # a converged spectral norm: largest singular value 1
            with torch.no_grad():
                for name, p in self.lstm.named_parameters():
                    if name.startswith("weight_hh"):
                        p.div_(torch.linalg.matrix_norm(p, ord=2))

    def forward(self, x, lengths=None):
        if lengths is None:
            return self.lstm(x)[0]
        T = x.shape[1]
        # pack_padded_sequence needs lengths >= 1 on the host; a length-0
        # item runs one frame and is zeroed below
        lens = lengths.detach().to("cpu", torch.int64).clamp(min=1)
        packed = pack_padded_sequence(x, lens, batch_first=True,
                                      enforce_sorted=False)
        y, _ = pad_packed_sequence(self.lstm(packed)[0], batch_first=True,
                                   total_length=T)
        return y * sequence_mask(lengths, T).to(y.dtype)[:, :, None]
