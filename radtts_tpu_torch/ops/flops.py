"""Matmul and conv FLOP counting of the port: the counterpart of
radtts_tpu/ops/flops.py, under the same convention.

Only matrix products and convolutions count, at 2*M*N*K each (a matvec
2*M*K, a dot 2*K): the "model FLOPs" numerator. A backward pass counts the
products it makes itself (no 3x factor). The JAX package walks a jaxpr;
here `fn` runs under a TorchDispatchMode that sees every aten op:
  aten.mm, addmm, bmm, baddbmm, mv, addmv, dot, vdot;
  aten.convolution (transposed too: 2 * output elements * input channels
  per group * taps, the JAX count of the lhs-dilated conv), and
  convolution_backward: one conv's worth for each of grad_input and
  grad_weight it computes;
  a cuDNN LSTM (aten._cudnn_rnn) per time step: 2 * B_t * 4H * (I + H)
  per direction and layer, B_t the items at step t (all B without
  packing, as the JAX scan's trips), and its backward
  (_cudnn_rnn_backward) one such pass for the data gradients and one for
  the weight gradient (a oneDNN LSTM layer, mkldnn_rnn_layer, likewise).
  On the CPU an LSTM runs as per-step mm/addmm ops, which count as they
  are.
The port's own kernels (ops/mrf.py:mrf, ops/mel.py:mel,
ops/ar_scan.py:ar_scan_multi, ops/lstm.py:lstm_cuda) run outside aten on
the card; each is
wrapped by `counted` with the records of its plain version's products,
and what it dispatches inside is not counted, on the CPU and on the card
alike. MAS (ops/mas.py) is a DP of maxima and sums with no product: it
counts 0 on both, as the JAX package's mas_width1 has no dot.

Records (`mxu_records`) have the JAX package's fields: kind ("dot",
"conv" or "lstm"), batch, m, n, k, flops, trips and bytes (operands read
once, the result written once). trips is the time steps of an LSTM op or
of a hand-written scan (ar_scan's frames), else 1; unlike the JAX
package's records, flops and bytes are over all trips (an LSTM's m is its
items of every step together).
"""

import contextlib
import functools
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
_counters = []      # the counters running, innermost last


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def record(kind, batch, m, n, k, trips=1, nbytes=0):
    """One record: a product of (m x k) by (k x n), `batch` times at each
    of `trips` steps; flops and bytes are over all of them."""
    return dict(kind=kind, batch=batch, m=m, n=n, k=k,
                flops=2 * batch * m * n * k * trips, trips=trips,
                bytes=nbytes * trips)


def _dot(a, b, out):
    if a.dim() == 1 and b.dim() == 1:
        return record("dot", 1, 1, 1, a.shape[0], nbytes=_nbytes(a, b, out))
    if b.dim() == 1:
        return record("dot", 1, a.shape[0], 1, a.shape[1],
                      nbytes=_nbytes(a, b, out))
    if a.dim() == 3:
        return record("dot", a.shape[0], a.shape[1], b.shape[2], a.shape[2],
                      nbytes=_nbytes(a, b, out))
    return record("dot", 1, a.shape[0], b.shape[1], a.shape[1],
                  nbytes=_nbytes(a, b, out))


def conv_record(out_shape, weight_shape, transposed, groups, nbytes=0):
    """A convolution by its output and weight shapes: M = output elements
    per channel, N = output channels, K = input channels per group x
    taps."""
    if transposed:
        c_in, c_out = weight_shape[0] // groups, weight_shape[1] * groups
    else:
        c_in, c_out = weight_shape[1], weight_shape[0]
    taps = math.prod(weight_shape[2:])
    return record("conv", 1, math.prod(out_shape) // c_out, c_out,
                  c_in * taps, nbytes=nbytes)


def _lstm(inp, hidden_size, num_layers, bidirectional, batch_first,
          batch_sizes, weight_floats):
    """An LSTM op's forward pass: one record a layer and direction."""
    dirs = 2 if bidirectional else 1
    batch_sizes = list(batch_sizes or [])
    if batch_sizes:
        rows, trips = int(sum(batch_sizes)), len(batch_sizes)
    else:
        rows = inp.numel() // inp.shape[-1]
        trips = inp.shape[1] if batch_first else inp.shape[0]
    out = []
    for layer in range(num_layers):
        size_in = inp.shape[-1] if layer == 0 else hidden_size * dirs
        for _ in range(dirs):
            # rows: the items of every step together
            r = record("lstm", 1, rows, 4 * hidden_size,
                       size_in + hidden_size,
                       nbytes=4 * (weight_floats + 2 * rows
                                   * (size_in + hidden_size)))
            r["trips"] = trips
            out.append(r)
    return out


def _named(func, args, kwargs):
    """The op's arguments by their schema names."""
    out = dict(zip((a.name for a in func._schema.arguments), args))
    out.update(kwargs)
    return out


def _records(func, args, kwargs, out):
    """The records of one aten op, or []."""
    packet = func.overloadpacket
    if packet in (aten.mm, aten.bmm, aten.mv, aten.dot, aten.vdot):
        return [_dot(args[0], args[1], out)]
    if packet in (aten.addmm, aten.baddbmm, aten.addmv):
        return [_dot(args[1], args[2], out)]
    if packet not in _NAMED:
        return []
    a = _named(func, args, kwargs)
    if packet is aten.convolution:
        return [conv_record(out.shape, a["weight"].shape, a["transposed"],
                            a["groups"], _nbytes(a["input"], a["weight"],
                                                 out))]
    if packet is aten.convolution_backward:
        one = conv_record(a["grad_output"].shape, a["weight"].shape,
                          a["transposed"], a["groups"],
                          _nbytes(a["grad_output"], a["input"],
                                  a["weight"]))
        mask = a["output_mask"]
        return [one] * (int(bool(mask[0])) + int(bool(mask[1])))
    if packet in (aten._cudnn_rnn, aten._cudnn_rnn_backward):
        fwd = _lstm(a["input"], a["hidden_size"], a["num_layers"],
                    a["bidirectional"], a["batch_first"], a["batch_sizes"],
                    sum(w.numel() for w in a["weight"]))
        if packet is aten._cudnn_rnn:
            return fwd
        mask = a["output_mask"]
        return fwd * (int(any(mask[:3])) + int(bool(mask[3])))
    # mkldnn_rnn_layer(_backward): one layer and direction an op
    fwd_op = packet is aten.mkldnn_rnn_layer
    w_ih, w_hh = ((a["weight0"], a["weight1"]) if fwd_op
                  else (a["weight1"], a["weight2"]))
    H = w_hh.shape[-1]
    fwd = _lstm(a["input"], H, 1, False, a["batch_first"],
                a["batch_sizes"], w_ih.numel() + w_hh.numel())
    return fwd if fwd_op else fwd * 2


_NAMED = (aten.convolution, aten.convolution_backward, aten._cudnn_rnn,
          aten._cudnn_rnn_backward, aten.mkldnn_rnn_layer,
          aten.mkldnn_rnn_layer_backward)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.records = []
        self.hidden = 0      # depth of `counted` regions entered

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.hidden:
            self.records += _records(func, args, kwargs or {}, out)
        return out


def counted(records_fn):
    """Decorator of an op whose work runs outside aten (a hand-written
    kernel) or should count as one unit: while a counter runs, the op
    counts as records_fn(*args, **kwargs) (the products of its plain
    version) and nothing it dispatches counts."""
    def wrap(fn):
        @functools.wraps(fn)
        def op(*args, **kwargs):
            if not _counters:
                return fn(*args, **kwargs)
            counter = _counters[-1]
            if not counter.hidden:
                counter.records += records_fn(*args, **kwargs)
            counter.hidden += 1
            try:
                return fn(*args, **kwargs)
            finally:
                counter.hidden -= 1
        return op
    return wrap


@contextlib.contextmanager
def counting():
    """A counter over the block; yields its list of records. Inside
    torch.inference_mode, composite ops (conv1d, linear, lstm) would reach
    the counter whole; the block leaves inference mode (grad stays off) so
    that they reach it as the products they run."""
    counter = _Counter()
    _counters.append(counter)
    try:
        with contextlib.ExitStack() as stack:
            if torch.is_inference_mode_enabled():
                stack.enter_context(torch.inference_mode(False))
                stack.enter_context(torch.no_grad())
            stack.enter_context(counter)
            yield counter.records
    finally:
        _counters.pop()


def mxu_records(fn, *args, **kwargs):
    """Every matmul, conv and LSTM product of one call of fn (run, not
    traced), as records (see the module's docstring)."""
    with counting() as records:
        fn(*args, **kwargs)
    return list(records)


def count_matmul_flops(fn, *args, **kwargs):
    """Matmul/conv FLOP of one call of fn. For a function that runs a
    backward pass, its products are part of the count."""
    return sum(r["flops"] for r in mxu_records(fn, *args, **kwargs))
