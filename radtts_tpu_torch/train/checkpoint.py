"""RADTTS checkpoint reading for inference: the JAX package's native .npz
format and the reference's torch checkpoints, into a RADTTS module.

The .npz format (written by the JAX package's save_checkpoint) holds one
array per leaf of the parameter tree under `params/<path>`, the path's
components joined by '/', a component made of digits being a list index,
and the optimizer state under `opt/<path>`; a JSON sidecar beside it holds
the iteration and learning rate. The optimizer state is optax's: each
RAdam, Adam or AdamW state under its position in the chain (`1/` after the
global-norm clip) as `.count`, `.mu/<path>` and `.nu/<path>`, the moment
trees keyed like `params/` (`opt_moments` reads them; a resume carries
them into the port's optimizer through convert.optimizer_state_from_jax).
A reference checkpoint is a torch.save of {'state_dict': ...,
'iteration': ..., 'learning_rate': ...} (or the bare state dict), read by
convert.radtts_from_torch. Both give the nested numpy tree that
convert.radtts_from_jax takes.

The port's own training checkpoint (train/trainer.py) is a torch.save of
{"model": the training-form state dict, "optimizer", "iteration",
"learning_rate"} at OUT/model_<iteration>, with no
extension; it serves after its norms are folded (models/radtts.py:
fold_radtts), resumes, and warm-starts. A tensor-parallel run writes the
single-process layout and loads files whole before it shards the model
(parallel.shard_model), so resume and warm start read every format into a
sharded run unchanged.
"""

import json
import os
import re

import numpy as np
import torch

from radtts_tpu_torch.convert import (element_map, optimizer_state_from_jax,
                                      radtts_from_jax, radtts_from_torch,
                                      radtts_train_from_jax)
from radtts_tpu_torch.models.radtts import RADTTS, fold_radtts


def _listify(node):
    """Dicts whose keys are all digits become lists, in index order."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def tree_from_flat(flat):
    """{'a/0/w': array, ...} -> {'a': [{'w': array}], ...}."""
    root = {}
    for key, value in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return _listify(root)


def load_checkpoint(path):
    """A .npz checkpoint's parameter tree (the `params/` entries; `opt/` is
    ignored) and its sidecar's meta. Every floating leaf comes back fp32
    (the writer stores a bf16 leaf as fp32, exactly)."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    flat = {}
    with np.load(npz_path) as data:
        for k in data.files:
            if k.startswith("params/"):
                a = data[k]
                if a.dtype.kind == "f":
                    a = a.astype(np.float32, copy=False)
                flat[k[len("params/"):]] = a
    meta = {"iteration": 0, "learning_rate": 0.0}
    meta_path = npz_path[:-4] + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta.update(json.load(f))
    return tree_from_flat(flat), meta


_OPT_KEY = re.compile(r"^opt/(.*?)\.(count|mu|nu)(?:/(.*))?$")


def opt_moments(path):
    """The optax moment states of an .npz: {chain position prefix (e.g.
    "1/", "g/0/"): {"count": int, "mu": tree, "nu": tree}}, the trees
    keyed like the parameters, fp32 (the writer stores bf16 moments as
    fp32, exactly); a state with a count alone (a schedule's) has only
    "count". Empty for a file without `opt/` entries."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    groups = {}
    with np.load(npz_path) as data:
        for k in data.files:
            m = _OPT_KEY.match(k)
            if m is None:
                continue
            prefix, kind, leaf = m.groups()
            g = groups.setdefault(prefix, {})
            if kind == "count":
                g["count"] = int(data[k])
            else:
                g.setdefault(kind, {})[leaf] = data[k].astype(
                    np.float32, copy=False)
    for g in groups.values():
        for kind in ("mu", "nu"):
            if kind in g:
                g[kind] = tree_from_flat(g[kind])
    return groups


def is_torch_checkpoint(path):
    return not (path.endswith(".npz")
                or os.path.exists(path + ".npz"))


def _meta(ckpt):
    return {"iteration": int(ckpt.get("iteration", 0)),
            "learning_rate": float(ckpt.get("learning_rate", 0.0))}


def is_port_train_checkpoint(ckpt):
    return isinstance(ckpt, dict) and "model" in ckpt \
        and "state_dict" not in ckpt


def is_state_dict(params):
    """A port training checkpoint's state dict, not a parameter tree."""
    return all(isinstance(v, torch.Tensor) for v in params.values())


def load_any_radtts_checkpoint(path, model_config):
    """The .npz or a reference checkpoint as (numpy parameter tree, meta);
    a port training checkpoint as (its state dict, meta)."""
    if is_torch_checkpoint(path):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if is_port_train_checkpoint(ckpt):
            return ckpt["model"], _meta(ckpt)
        sd = ckpt.get("state_dict", ckpt)
        return radtts_from_torch(sd, model_config), _meta(ckpt)
    return load_checkpoint(path)


def load_radtts_for_inference(path, model_config):
    """(RADTTS module on the CPU, eval, no grad; meta) from any of the
    three formats."""
    params, meta = load_any_radtts_checkpoint(path, model_config)
    if is_state_dict(params):
        model = RADTTS(model_config, factored=True)
        model.load_state_dict(params)
        return fold_radtts(model), meta
    return radtts_from_jax(params, model_config), meta


def save_train_checkpoint(path, model_state, optimizer_state, iteration,
                          learning_rate):
    """The port's training checkpoint (see the module's docstring) from
    the model's and the optimizer's state dicts, which a tensor-parallel
    run gathers into the single-process layout first
    (parallel.full_train_state), so every file loads in one process."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": model_state,
                "optimizer": optimizer_state,
                "iteration": int(iteration),
                "learning_rate": float(learning_rate)}, tmp)
    os.replace(tmp, path)


def load_train_checkpoint(path, model, optimizer, model_config):
    """Resume (reference: train.py:179-187): the model's factored state and
    the optimizer's from a port checkpoint or the JAX package's .npz (its
    RAdam or Adam count and moments, each carried through the parameter's
    own layout change; a parameter whose moments cannot be carried raises
    by name); a reference checkpoint fills the model only (the JAX
    package's resume of a torch file keeps a fresh optimizer too). Returns
    the meta."""
    device = next(model.parameters()).device
    if is_torch_checkpoint(path):
        ckpt = torch.load(path, map_location=device, weights_only=True)
        if is_port_train_checkpoint(ckpt):
            model.load_state_dict(ckpt["model"])
            if optimizer is not None and ckpt.get("optimizer"):
                optimizer.load_state_dict(ckpt["optimizer"])
            return _meta(ckpt)
    params, meta = load_any_radtts_checkpoint(path, model_config)
    model.load_state_dict(radtts_train_from_jax(params, model_config)
                          .state_dict())
    if optimizer is not None and not is_torch_checkpoint(path):
        load_jax_optimizer(path, params, model, optimizer, model_config)
    return meta


def load_jax_optimizer(path, params, model, optimizer, model_config):
    """The .npz's RAdam/Adam state (one moment state in its optax chain)
    into `optimizer` over model's parameters; nothing where the file has
    none or no update was made (count 0)."""
    states = [g for g in opt_moments(path).values() if "mu" in g]
    if not states:
        return
    if len(states) > 1:
        raise ValueError(f"{path}: {len(states)} moment states in the "
                         "optimizer, expected one (RAdam or Adam)")
    (st,) = states
    if st["count"] == 0:
        return
    emap = element_map(
        lambda tree: radtts_train_from_jax(tree, model_config), params)
    optimizer.load_state_dict(optimizer_state_from_jax(
        optimizer, model.named_parameters(), emap, st["count"], st["mu"],
        st["nu"]))


def warmstart_filter(include_layers, ignore_layers_warmstart):
    """Substring filters on parameter names (reference: train.py:159-176):
    a name is taken when it contains an include_layers entry (or the list
    is empty) and no ignore_layers_warmstart entry."""
    def fn(key):
        if include_layers and not any(l in key for l in include_layers):
            return False
        if ignore_layers_warmstart and any(
                l in key for l in ignore_layers_warmstart):
            return False
        return True
    return fn


def warmstart_state(path, model, model_config, include_layers=(),
                    ignore_layers_warmstart=()):
    """Partial load into a training-form model: every entry of the file's
    state (a port checkpoint's; a reference checkpoint's or an .npz's
    modules carried into the training form) that the model has and the
    filters pass. Returns the names loaded."""
    params, _ = load_any_radtts_checkpoint(path, model_config)
    if is_state_dict(params):
        source = params
    else:
        src_model, loaded = radtts_train_from_jax(params, model_config,
                                                  partial=True)
        source = {k: v for k, v in src_model.state_dict().items()
                  if k.split(".")[0] in loaded}
    keep = warmstart_filter(include_layers, ignore_layers_warmstart)
    target = model.state_dict()
    taken = []
    with torch.no_grad():
        for k, v in source.items():
            if k in target and keep(k):
                if tuple(v.shape) != tuple(target[k].shape):
                    raise ValueError(f"shape mismatch for {k}: checkpoint "
                                     f"{tuple(v.shape)} vs model "
                                     f"{tuple(target[k].shape)}")
                target[k].copy_(v)
                taken.append(k)
    return taken
