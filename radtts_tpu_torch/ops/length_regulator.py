"""Duration-based length regulation (token repetition) as one gather."""

import torch


def regulate_length(x, dur, max_frames):
    """x: (B, N, C) token features; dur: (B, N) integer frame counts.
    Returns (B, max_frames, C); frames past sum(dur) are zero."""
    ends = torch.cumsum(dur, dim=1)                           # (B, N)
    t = torch.arange(max_frames, device=x.device, dtype=ends.dtype)
    # frame t maps to the first token whose cumsum exceeds t
    idx = (ends[:, None, :] <= t[None, :, None]).sum(-1)      # (B, T)
    idx = idx.clamp(0, x.shape[1] - 1)
    out = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    valid = (t[None, :] < ends[:, -1:]).to(x.dtype)
    return out * valid[:, :, None]
