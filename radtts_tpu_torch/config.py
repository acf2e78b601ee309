"""Dot-path CLI overrides of a JSON config, as the reference CLIs take them
(reference: common.py:65-83): `-p a.b.c=value` is parsed with
`ast.literal_eval` and applied recursively; unknown keys print a notice and
are skipped. A copy of the JAX package's radtts_tpu/config.py:update_params.
"""

import ast


def update_params(config, params):
    """Apply a list of 'dot.path=value' overrides to a nested dict config."""
    for param in params:
        print(param)
        k, v = param.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass

        k_split = k.split(".")
        if len(k_split) > 1:
            parent_k = k_split[0]
            cur_param = [".".join(k_split[1:]) + "=" + str(v)]
            update_params(config[parent_k], cur_param)
        elif k in config and len(k_split) == 1:
            print(f"overriding {k} with {v}")
            config[k] = v
        else:
            print("{}, {} params not updated".format(k, v))
