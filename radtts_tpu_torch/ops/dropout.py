"""Inverted dropout from an explicit torch.Generator, as the JAX package
draws it from an explicit key (keep with probability 1 - p, kept values
scaled by 1 / (1 - p)). With no generator, or p = 0, the input is returned
as it is: the inference path."""

import torch


def dropout(x, p, generator=None):
    if generator is None or p == 0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
