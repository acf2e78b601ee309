"""Debug-mode numerical sentinels (radtts_tpu/debug.py).

The reference surfaces flow blow-ups early: it raises on NaN spline bin
indices (reference splines.py:81-82). The branch-free splines clamp
silently, so without a check an instability shows only as a diverging
loss. With the checks on, `check_finite` raises NumericalError, naming its
site, when a tensor holds a NaN or an Inf: the soft attention map, the
decoder flows' log_s and log_det_W, the spline bin inputs, and the AGAP
scan's output (ops/ar_scan.py, where the card's kernel runs the spline
inverse). Off (the default) a check does nothing: no reduction, no read
back, no synchronisation. On, each check reads one flag back from the
device.

Usage:
    from radtts_tpu_torch import debug
    debug.enable_numerical_checks()
    ...
    debug.enable_numerical_checks(False)
"""

import sys

import torch

_ENABLED = False


def enable_numerical_checks(flag=True):
    global _ENABLED
    _ENABLED = bool(flag)


def numerical_checks_enabled():
    return _ENABLED


class NumericalError(FloatingPointError):
    pass


def check_finite(x, name):
    """x, unchanged; with the checks on, raises NumericalError first if x
    holds a NaN or an Inf."""
    if _ENABLED and not bool(torch.isfinite(x).all()):
        msg = (f"non-finite values detected in {name} (debug-mode "
               f"numerical sentinel; reference parity: splines.py:81-82)")
        print(f"FATAL radtts_tpu_torch.debug: {msg}", file=sys.stderr,
              flush=True)
        raise NumericalError(msg)
    return x
