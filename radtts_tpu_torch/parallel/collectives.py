"""The collectives of tensor and data parallelism.

Three autograd functions carry a WN's activations across its model group
(models/coupling.py:WN), each taking a parallel.mesh.ModelShard:

  * copy_to_group: identity forward, all-reduce backward, on the
    replicated input of the column-parallel start conv, so that the
    context and z upstream get the whole gradient;
  * gather: forward the full-width activation from every rank's channel
    slice, backward this rank's slice of the summed gradient, before each
    in_layers[i] and res_skip[i], whose input must be whole;
  * reduce: all-reduce forward, identity backward, after the row-parallel
    end conv (whose bias is added once, after it).

The gather is an all-reduce of a zeroed full-width buffer into which each
rank wrote its slice (x + 0 is exact): gloo runs only all-reduce and
broadcast on CUDA tensors, and this one form runs on NCCL and gloo, on the
CPU and on the card.
"""

import torch
import torch.distributed as dist


def _all_reduce(x, group):
    dist.all_reduce(x, group=group)
    return x


def gather_along(x, axis, shard):
    """The full tensor of which x is this rank's slice along `axis`
    (no gradient)."""
    shape = list(x.shape)
    width = shape[axis]
    shape[axis] = width * shard.size
    full = x.new_zeros(shape)
    full.narrow(axis, shard.rank * width, width).copy_(x)
    return _all_reduce(full, shard.group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.group = shard.group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        ctx.width = x.shape[-1]
        return gather_along(x.contiguous(), x.dim() - 1, shard)

    @staticmethod
    def backward(ctx, grad):
        s, w = ctx.shard, ctx.width
        summed = _all_reduce(grad.contiguous().clone(), s.group)
        return summed[..., s.rank * w:(s.rank + 1) * w].contiguous(), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return _all_reduce(x.contiguous().clone(), shard.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x, shard):
    return _CopyToGroup.apply(x, shard)


def gather(x, shard):
    """x (..., C / n) -> (..., C), rank r's slice at [r C/n, (r+1) C/n)."""
    return _Gather.apply(x, shard)


def reduce(x, shard):
    return _Reduce.apply(x, shard)


def sum_over(tensors, group):
    """Sum each tensor over the group in one all-reduce of their
    concatenation, in place."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    _all_reduce(flat, group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
