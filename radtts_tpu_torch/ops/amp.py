"""bf16 mixed-precision regions, the port of radtts_tpu/ops/amp.py.

The reference trains and infers under torch AMP, with the text encoder and
the invertible 1x1 convs opted out (autocast(False)). The JAX package keeps
the same split by hand, and so does the port: inside a region the
activation is cast to bfloat16 on entry (`cast_in`) and the prediction
back to float32 on exit (`cast_out`). Weights follow the activation's
dtype (ops/conv.py, ops/linear.py, ops/lstm.py), so the region's convs,
dense layers and LSTM recurrences run in bf16, while the flow state, the
log-determinants, the losses, the text encoder and the 1x1 convs stay in
fp32. The regions, one per JAX cast site:

  * models/coupling.py: SimpleConvNet and WN, the coupling predictors;
  * models/attributes.py: ConvLSTMLinear, the DAP's conv front, LSTM and
    dense layer;
  * models/radtts.py: the context BiLSTM (RADTTS).

torch.autocast is not used: it would also cast the text encoder, the 1x1
convs and every other matmul, which the JAX package keeps in fp32.

The flag is carried on the model, never in a process global (the JAX
package reads a module global at trace time; in the port a global flipped
by one serving thread would reach another). Every region module holds an
`amp` attribute, False when built; `scope(model, enabled)` sets it on each
region module of the model for the length of a with block and puts back
what was there. The Synthesizer
scopes its durations and decode stages, the trainer its loss, as the JAX
package scopes the same calls; two threads that run one model with
different flags at once are not supported. bf16 has the fp32 exponent
range, so there is no loss scaler.

The hand kernels (the vocoder's MRF and mel kernels, MAS, the AR scan) lie
outside every region, as the vocoder and MAS do in the JAX package; their
wrappers raise on a non-fp32 input.
"""

from contextlib import contextmanager

import torch


def cast_in(x, enabled):
    """An activation entering a bf16 region."""
    if enabled and x.dtype == torch.float32:
        return x.to(torch.bfloat16)
    return x


def cast_out(x, enabled):
    """A prediction leaving a bf16 region for the fp32 world."""
    if enabled and x.dtype == torch.bfloat16:
        return x.to(torch.float32)
    return x


def regions(model):
    """The region modules of a model (those with an `amp` attribute)."""
    return [m for m in model.modules() if hasattr(m, "amp")]


@contextmanager
def scope(model, enabled=True):
    """Every region of model marked `enabled` inside the block, the old
    marks after."""
    mods = regions(model)
    before = [m.amp for m in mods]
    try:
        for m in mods:
            m.amp = bool(enabled)
        yield model
    finally:
        for m, b in zip(mods, before):
            m.amp = b
