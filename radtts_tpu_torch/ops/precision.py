"""Matmul precision of a serving run: the port of the JAX CLIs'
--matmul_precision (jax_default_matmul_precision).

"highest" (the default) keeps every product in fp32: no TF32 in cuBLAS or
cuDNN, and csrc/mrf_tc.cu in 3xTF32. "high" and "default" let cuBLAS and
cuDNN round fp32 operands to TF32, as XLA does at those precisions on a
Hopper card; "default" also runs the tensor-core MRF in one TF32 pass
(csrc/mrf_tf32.cu), the counterpart of the Pallas MRF's single
default-precision dot (radtts_tpu/ops/pallas_mrf.py:55-63).
The csrc/mrf_stack.cu and csrc/mrf.cu FMA kernels stay fp32 at every
setting.

The JAX package's fp32 islands stay fp32 at every setting (`island`): the
text encoder (radtts_tpu/models/encoder.py:41-45), the inverse 1x1 convs
(ops/invertible.py), the denoiser's STFT (ops/stft.py) and the log-mel
(ops/mel.py).

Both are scopes, never global switches: `scope(precision)` sets the flags
for the block and restores them after, so loading a model (which pins
fp32 through synthesizer.resolve_device) cannot undo a precision given to
the Synthesizer.
"""

import contextlib
import functools

import torch

PRECISIONS = ("default", "high", "highest")
_current = ["highest"]


def check(precision):
    """None -> "highest"; one of PRECISIONS; anything else raises."""
    precision = precision or "highest"
    if precision not in PRECISIONS:
        raise ValueError(f"matmul_precision={precision!r}: expected one of "
                         f"{PRECISIONS}")
    return precision


@contextlib.contextmanager
def _tf32(allow):
    """cuDNN's and cuBLAS's TF32 switches set to `allow` inside the block,
    both restored after it. (torch.backends.cudnn.flags would also reset
    the other cuDNN flags it takes, such as benchmark_limit, to its own
    defaults.)"""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = allow
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@contextlib.contextmanager
def scope(precision):
    """Run the block at `precision` (see the module's docstring)."""
    precision = check(precision)
    prev = _current[0]
    _current[0] = precision
    try:
        with _tf32(precision != "highest"):
            yield
    finally:
        _current[0] = prev


def island(fn):
    """fn made an fp32 island: each call runs at "highest" whatever the
    scope."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with scope("highest"):
            return fn(*args, **kwargs)
    return wrapper


def mrf_passes():
    """TF32 passes of the tensor-core MRF at the current precision: 1 at
    "default", else 3 (ops/mrf.py:mrf_route names the kernel)."""
    return 1 if _current[0] == "default" else 3
