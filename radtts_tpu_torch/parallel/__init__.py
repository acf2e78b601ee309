"""Training and serving on more than one device: the (data, model) mesh
over torch.distributed (mesh.py), the collectives of tensor parallelism
(collectives.py) and the placement of a sharded model (shard_model,
full_train_state)."""

import torch


def shard_model(model, optimizer, mesh):
    """Keep this rank's shard of every tensor-parallel parameter of the
    training-form model and of its optimizer moments (convert.
    shard_train_model, by parallel.mesh.tp_axis), and switch each WN whose
    channels were sharded to the sharded forward. A no-op without a mesh
    or at n_model 1. Returns {parameter name: sharded axis}."""
    from radtts_tpu_torch.convert import shard_train_model
    from radtts_tpu_torch.models.coupling import WN

    if mesh is None or mesh.n_model == 1:
        return {}
    axes = shard_train_model(model, optimizer, mesh.n_model, mesh.model_rank)
    for name, module in model.named_modules():
        if isinstance(module, WN) and f"{name}.start.weight_v" in axes:
            module.tp = mesh.model_shard
    return axes


@torch.no_grad()
def full_train_state(model, optimizer, mesh, axes):
    """(model state dict, optimizer state dict) of the whole model: each
    shard gathered over the model group (every rank of the group must call
    this), so that a file written from it has the single-process layout."""
    from radtts_tpu_torch.convert import unshard_train_state
    from radtts_tpu_torch.parallel.collectives import gather_along

    shard = None if mesh is None else mesh.model_shard
    return unshard_train_state(
        model, optimizer, axes,
        lambda t, axis: gather_along(t.contiguous(), axis, shard))
