"""Sequence masking utilities."""

import torch


def sequence_mask(lengths, max_len):
    """lengths (B,) int -> bool mask (B, max_len), True where t < length."""
    t = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return t[None, :] < lengths[:, None]
