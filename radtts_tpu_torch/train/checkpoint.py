"""RADTTS checkpoint reading for inference: the JAX package's native .npz
format and the reference's torch checkpoints, into a RADTTS module.

The .npz format (written by the JAX package's save_checkpoint) holds one
array per leaf of the parameter tree under `params/<path>`, the path's
components joined by '/', a component made of digits being a list index,
and the optimizer state under `opt/<path>`; a JSON sidecar beside it holds
the iteration and learning rate. A reference checkpoint is a torch.save of
{'state_dict': ..., 'iteration': ..., 'learning_rate': ...} (or the bare
state dict), read by convert.radtts_from_torch. Both give the nested numpy
tree that convert.radtts_from_jax takes.
"""

import json
import os

import numpy as np
import torch

from radtts_tpu_torch.convert import radtts_from_jax, radtts_from_torch


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


def is_torch_checkpoint(path):
    return not (path.endswith(".npz")
                or os.path.exists(path + ".npz"))


def load_any_radtts_checkpoint(path, model_config):
    """Either format as (numpy parameter tree, meta)."""
    if is_torch_checkpoint(path):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt.get("state_dict", ckpt)
        meta = {"iteration": int(ckpt.get("iteration", 0)),
                "learning_rate": float(ckpt.get("learning_rate", 0.0))}
        return radtts_from_torch(sd, model_config), meta
    return load_checkpoint(path)


def load_radtts_for_inference(path, model_config):
    """(RADTTS module on the CPU, eval, no grad; meta) from either
    format."""
    params, meta = load_any_radtts_checkpoint(path, model_config)
    return radtts_from_jax(params, model_config), meta
