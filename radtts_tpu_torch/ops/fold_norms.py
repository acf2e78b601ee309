"""Load-time norm folding on a JAX-format parameter tree (nested dicts and
lists of numpy arrays): every conv weight-norm factorization {v, g [, b]}
becomes {w [, b]} and every LSTM recurrent-weight factorization ({sn_w,
sn_u, sn_v} or {wn_v, wn_g}) becomes {w}. The math is the JAX package's
fold_norms at fp32 (the reference's remove_norms); no dtype cast.
"""

from radtts_tpu_torch.ops.conv import effective_weight
from radtts_tpu_torch.ops.lstm import effective_hh


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
