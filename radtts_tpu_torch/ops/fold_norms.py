"""Load-time norm folding on a JAX-format parameter tree (nested dicts and
lists of numpy arrays): every conv weight-norm factorization {v, g [, b]}
becomes {w [, b]} and every LSTM recurrent-weight factorization ({sn_w,
sn_u, sn_v} or {wn_v, wn_g}) becomes {w}. The math is the JAX package's
fold_norms at fp32 (the reference's remove_norms).

`store_conv_weights` is the dtype half of the JAX package's
fold_norms(..., matmul_dtype=bfloat16) (radtts_tpu/ops/fold_norms.py:
45-94), applied to the port's modules after loading: every conv kernel is
stored in bf16, except under the text encoder (_NO_CAST_KEYS, an fp32
island: the reference runs it under autocast(False)). Biases, embeddings,
LSTMs, dense layers and the invertible 1x1 factors stay fp32. A bf16
kernel with an fp32 activation computes with fp32 sums and output
(ops/conv.py:conv1d); the point is halving the resident conv-weight
bytes.
"""

import torch

from radtts_tpu_torch.ops.conv import ConvNorm, effective_weight
from radtts_tpu_torch.ops.lstm import effective_hh

# fp32 islands: module names never dtype-cast
_NO_CAST_KEYS = ("encoder",)


def fold_norms(params):
    def check(node, allowed):
        # the rewrite replaces the whole dict: refuse to drop unknown keys
        extra = set(node) - allowed
        if extra:
            raise ValueError(
                f"fold_norms: dict matching pattern {sorted(allowed)} "
                f"carries unexpected keys {sorted(extra)}")

    def walk(node):
        if isinstance(node, dict):
            if "v" in node and "g" in node and getattr(
                    node["v"], "ndim", 0) == 3:
                check(node, {"v", "g", "b"})
                out = {"w": effective_weight(node)}
                if "b" in node:
                    out["b"] = node["b"]
                return out
            if "sn_w" in node or ("wn_v" in node and "wn_g" in node):
                check(node, {"sn_w", "sn_u", "sn_v"} if "sn_w" in node
                      else {"wn_v", "wn_g"})
                return {"w": effective_hh(node)}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


@torch.no_grad()
def store_conv_weights(model, dtype=torch.bfloat16):
    """Store the folded conv kernels of model in dtype, in place, outside
    _NO_CAST_KEYS; returns model."""
    for name, m in model.named_modules():
        if (isinstance(m, ConvNorm) and not m.weight_norm
                and not set(name.split(".")) & set(_NO_CAST_KEYS)):
            m.weight.data = m.weight.data.to(dtype)
    return model


def conv_weight_bytes(model):
    """Resident bytes of model's conv kernels (ConvNorm weights)."""
    return sum(m.weight.numel() * m.weight.element_size()
               for m in model.modules()
               if isinstance(m, ConvNorm) and not m.weight_norm)
