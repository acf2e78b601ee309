"""Spans and counters of the port, on the profiler's clock.

Tracing is on exactly while a torch profiler records
(torch.autograd._profiler_enabled(), the check record_function makes
itself): the benchmark's traced window, the trainer's `profile_dir`
window, or an operator's own `torch.profiler.profile()`. There is no other
switch. Off, `span` costs that one check and returns one shared null
context: it makes no record and no CUDA event and never synchronizes;
`count` costs the same check.

On, a span is a `torch.profiler.record_function("radtts.<name>")` range,
so it lies on the same clock as the device's kernels in any trace, and a
record kept in memory (`records()`, a bounded deque; `clear()` empties
it) with:

    name, parents    the span's name and those of the spans open around
                     it on its thread, outermost first
    call             the id of the Synthesizer.synthesize call it belongs
                     to (one per call, shared by each of the call's spans;
                     None outside a call)
    t0, t1           host time.perf_counter() at its start and end
    ev               on CUDA, a pair of timing events recorded on the
                     current stream of the span's device; `device_ms`
                     reads their elapsed time after the reader has
                     synchronized
    counts           what `count` added while it was open, its subtree's
                     totals (the root's are the call's)
    attrs            a few attributes: shapes, a read's site

Counters:

    syncs       +1 at every blocking transfer on the synthesis path: a
                device->host read (a `readback` span, with its `site`)
                or a host->device copy from pageable memory (an `upload`
                span); each blocks the host until the device drains its
                queue, and is what torch.cuda.set_sync_debug_mode
                reports
    lstm_steps  padded time steps x directions x layers of each LSTM
                run: the recurrence's work, whatever implements it
"""

import collections
import contextlib
import itertools
import threading
import time

import torch

PREFIX = "radtts."
MAX_RECORDS = 1 << 16          # ~1300 synthesize calls of ~50 spans

_records = collections.deque(maxlen=MAX_RECORDS)
_local = threading.local()
_call_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


def records():
    """The completed span records, oldest first."""
    return list(_records)


def clear():
    _records.clear()


def calls():
    """The records of each traced synthesize call, {call id: [records,
    the root `synthesize` last]}, oldest call first; a call whose root
    has not ended is left out."""
    out = {}
    for rec in list(_records):
        if rec["call"] is not None:
            out.setdefault(rec["call"], []).append(rec)
    return {cid: recs for cid, recs in out.items()
            if recs[-1]["name"] == "synthesize"}


def device_ms(rec):
    """A record's device milliseconds between its CUDA events, None where
    it has none (a CPU span). The caller synchronizes first."""
    ev = rec.get("ev")
    return None if ev is None else ev[0].elapsed_time(ev[1])


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One open span (see the module's docstring)."""

    __slots__ = ("rec", "device", "syncs", "root", "range", "prev_call")

    def __init__(self, name, device, attrs, syncs=0, root=False):
        self.rec = {"name": name, "attrs": attrs, "counts": {}}
        self.device = None if device is None else torch.device(device)
        self.syncs = syncs
        self.root = root

    def __enter__(self):
        rec, stack = self.rec, _stack()
        if self.root:
            self.prev_call = getattr(_local, "call", None)
            _local.call = next(_call_ids)
        rec["parents"] = [s["name"] for s in stack]
        rec["call"] = getattr(_local, "call", None)
        self.range = torch.profiler.record_function(PREFIX + rec["name"])
        self.range.__enter__()
        if self.device is not None and self.device.type == "cuda":
            rec["ev"] = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            rec["ev"][0].record(torch.cuda.current_stream(self.device))
        stack.append(rec)
        if self.syncs:
            count("syncs", self.syncs)
        rec["t0"] = time.perf_counter()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec["t1"] = time.perf_counter()
        _stack().pop()
        if "ev" in rec:
            rec["ev"][1].record(torch.cuda.current_stream(self.device))
        self.range.__exit__(*exc)
        if self.root:
            _local.call = self.prev_call
        _records.append(rec)
        return False


def span(name, device=None, **attrs):
    """A span `name` around the work of its `with` block, timed on
    `device` (CUDA events only there). `with span(...) as rec` gives the
    record, to add attributes that cost work, or None with tracing off."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, device, attrs)


def call(name, device=None, **attrs):
    """The root span of a synthesize call: as `span`, and every span
    opened inside it takes a new call id."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, device, attrs, root=True)


def readback(site, device=None, n=1):
    """A `readback` span around a device->host read at `site` that blocks
    the host: counts n `syncs` (a read of n tensors counts n)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span("readback", device, {"site": site}, syncs=n)


def upload(site, device=None, n=1):
    """An `upload` span around a host->device copy at `site` from pageable
    memory, which PyTorch makes blocking (it synchronizes the stream):
    counts n `syncs`."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span("upload", device, {"site": site}, syncs=n)


def annotate(**attrs):
    """Adds attributes to the innermost open span."""
    if not torch.autograd._profiler_enabled():
        return
    stack = _stack()
    if stack:
        stack[-1]["attrs"].update(attrs)


def count(name, n=1):
    """Adds n to counter `name` of every span open on this thread."""
    if not torch.autograd._profiler_enabled():
        return
    for rec in _stack():
        counts = rec["counts"]
        counts[name] = counts.get(name, 0) + n
