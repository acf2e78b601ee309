"""radtts_tpu_torch/tracing.py on the CPU, on tiny DAP and AGAP
Synthesizers: the span tree of a call under a torch profiler, its call
ids, its counters (syncs at every blocking transfer the call passes,
lstm_steps from the model's shapes), the radtts.* ranges in the
profiler's events, nothing recorded and the same outputs with the
profiler off, and the benchmark's four readers of the records.

Tests marked `chip` run on the card: one call of each benchmark cell's
configuration under torch.cuda.set_sync_debug_mode("warn") raises as
many synchronizing-operation warnings as `syncs` counts, every masked
LSTM run of such a call takes csrc/lstm.cu with 8 syncs a call, and a traced
benchmark run reports the four metrics and lists no radtts.* range among
its kernels. Run them there without the JAX conftest:
`python3 -m pytest --noconftest -m chip tests/test_torch_tracing.py`.
"""

import copy
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from radtts_tpu_torch import tracing
from radtts_tpu_torch.models.hifigan import Generator, denoiser_init
from radtts_tpu_torch.models.radtts import RADTTS
from radtts_tpu_torch.synthesizer import Synthesizer, frame_budget

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["A quick check of the spans.", "Short one!",
         "A middle text, of some length."]
AGAP = {"name": "agap", "hparams": {
    "n_in_dim": 1, "n_group_size": 1, "take_log_of_input": False,
    "n_speaker_dim": 8, "n_flows": 2, "n_hidden": 16, "n_lstm_layers": 1,
    "scaling_fn": "tanh",
    "bottleneck_hparams": {"in_dim": 64, "reduction_factor": 16,
                           "norm": "weightnorm", "non_linearity": "relu",
                           "use_partial_padding": True, "kernel_size": 3},
    "spline_flow_params": {"n_in_channels": 1, "n_context_dim": 16,
                           "n_layers": 2, "n_bins": 4,
                           "use_quadratic": True}}}
READERS = ("frontend_ms", "syncs", "lstm_step_us", "flows_ms")


def _synth(kind):
    """A tiny Synthesizer on the CPU: tests/test_torch_synthesizer.py's
    DAP model, or the same with AGAP f0 and energy. (Test modules are
    imported here, not at the top: the card's run of this file imports
    none.)"""
    from tests.test_torch_synthesizer import CFG, H_SMALL, _encode, _parts
    if kind == "dap":
        return Synthesizer.from_parts(**_parts("cpu"))
    cfg = dict(CFG, f0_model_config=copy.deepcopy(AGAP),
               energy_model_config=copy.deepcopy(AGAP))
    torch.manual_seed(0)
    model = RADTTS(cfg)
    torch.nn.init.constant_(model.dur_pred_layer.feat.dense.bias, 1.4)
    vocoder = Generator(H_SMALL)
    with torch.no_grad():
        denoiser = denoiser_init(vocoder)
    return Synthesizer.from_parts(
        cfg, model, vocoder, denoiser, encode_fn=_encode,
        speaker_id_fn=lambda name: 0, seed=11, device="cpu")


def _traced(synth, n_calls=1, texts=TEXTS):
    """n_calls synthesize calls under a CPU profiler: (outputs of the
    last, {call id: records}, the profiler's event names)."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n_calls):
            out = synth.synthesize(texts, "spk")
    names = {e.name for e in prof.events()}
    return out, tracing.calls(), names


def _lstms_with_lengths(model):
    """The masked LSTM runs of a batched call: the text encoder's (in
    durations and in decode), each LSTM-carrying DAP's, the context's."""
    daps = [m for m in (model.dur_pred_layer, model.f0_pred_module,
                        model.energy_pred_module, model.v_pred_module)
            if m.name == "dap" and m.feat.lstm is not None]
    return 2 + len(daps) + int(model.meta["use_context_lstm"])


@pytest.fixture(scope="module", params=["dap", "agap"])
def traced(request):
    synth = _synth(request.param)
    (wavs, aux), calls, names = _traced(synth, n_calls=2)
    return request.param, synth, aux, calls, names


def test_span_tree(traced):
    """Two calls: one call id each, shared by all its spans, distinct
    between them; the layer spans under their parents."""
    kind, synth, _, calls, _ = traced
    assert len(calls) == 2 and len(set(calls)) == 2
    for cid, recs in calls.items():
        assert {r["call"] for r in recs} == {cid}
        root = recs[-1]
        assert root["name"] == "synthesize" and root["parents"] == []
        assert root["attrs"]["B"] == len(TEXTS)
        under = {(r["name"], tuple(r["parents"])) for r in recs}
        for name, parents in [
                ("frontend", ("synthesize",)),
                ("noise", ("synthesize",)),
                ("durations", ("synthesize",)),
                ("text_encoder", ("synthesize", "durations")),
                ("attributes", ("synthesize", "durations")),
                ("decode", ("synthesize",)),
                ("text_encoder", ("synthesize", "decode")),
                ("attributes", ("synthesize", "decode")),
                ("context", ("synthesize", "decode")),
                ("flows", ("synthesize", "decode")),
                ("vocoder", ("synthesize",)),
                ("mrf", ("synthesize", "vocoder")),
                ("denoiser", ("synthesize",)),
                ("upload", ("synthesize", "frontend")),
                ("readback", ("synthesize",)),
                ("lstm", ("synthesize", "durations", "text_encoder")),
                ("lstm", ("synthesize", "decode", "context"))]:
            assert (name, parents) in under, (name, parents)
        n_attr = sum(1 for r in recs if r["name"] == "attributes"
                     and r["parents"] == ["synthesize", "decode"])
        # DAP: voicing, f0, energy; AGAP: voicing, then f0 and energy in
        # one lock-step call
        assert n_attr == (3 if kind == "dap" else 2)
        assert sum(r["name"] == "mrf" for r in recs) == 4
        assert len(recs) <= 50
        for r in recs:
            assert r["t0"] <= r["t1"] and "ev" not in r   # CPU: no events


def test_lstm_steps(traced):
    """lstm_steps = padded steps x directions x layers of every LSTM run,
    from the model's shapes: N tokens for the text encoder (twice) and
    the duration DAP, max_frames for the frame-level DAPs, max_frames / g
    for the context LSTM."""
    from tests.test_torch_synthesizer import _encode
    kind, synth, aux, calls, _ = traced
    model = synth.model
    N = (max(len(_encode(t)) for t in TEXTS) + 15) // 16 * 16
    g = model.meta["n_group_size"]
    T = frame_budget(aux["n_frames"].max(), g)
    frame_daps = [m for m in (model.f0_pred_module,
                              model.energy_pred_module, model.v_pred_module)
                  if m.name == "dap" and m.feat.lstm is not None]
    want = 2 * (2 * N + N + len(frame_daps) * T + T // g)
    root = list(calls.values())[-1][-1]
    assert root["attrs"]["N"] == N and root["attrs"]["max_frames"] == T
    assert root["counts"]["lstm_steps"] == want
    lstm = [r for r in list(calls.values())[-1] if r["name"] == "lstm"]
    assert len(lstm) == 3 + len(frame_daps) + 1


def test_syncs_count_every_site(traced):
    """syncs = the blocking transfers the call passes: the tokens and
    lengths up (2), each masked LSTM's lengths read, sort order up and
    back (3), the duration totals read and copied back (2), the outputs
    read (waveforms, durations, f0, energy: 4)."""
    kind, synth, _, calls, _ = traced
    want = 2 + 3 * _lstms_with_lengths(synth.model) + 2 + 4
    for recs in calls.values():
        root = recs[-1]
        assert root["counts"]["syncs"] == want
        sites = [(r["name"], r["attrs"]["site"]) for r in recs
                 if r["name"] in ("readback", "upload")]
        n = {"readback": 0, "upload": 0}
        for name, _ in sites:
            n[name] += 1
        assert n["upload"] == 2 + _lstms_with_lengths(synth.model) + 1
        assert ({s for _, s in sites}
                == {"tokens", "lengths", "totals", "outputs"})
        # a span's syncs are those of the transfers inside it
        transfers = [r for r in recs if r["name"] in ("readback", "upload")]
        for r in recs:
            inside = [q for q in transfers
                      if q is r or r["name"] in q["parents"]]
            if r["name"] in ("synthesize", "durations", "decode"):
                assert r["counts"].get("syncs", 0) == sum(
                    q["counts"]["syncs"] for q in inside), r["name"]


def test_profiler_holds_the_ranges(traced):
    _, _, _, _, names = traced
    for name in ("synthesize", "frontend", "durations", "text_encoder",
                 "attributes", "decode", "context", "flows", "lstm",
                 "vocoder", "mrf", "denoiser", "noise", "readback",
                 "upload"):
        assert tracing.PREFIX + name in names, name


def test_off_records_nothing_and_changes_nothing():
    """Without a profiler no record is made and a span is the one shared
    null context; the outputs are bitwise those of a traced call."""
    tracing.clear()
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("x") is tracing.span("y") is tracing.readback("z")
    tracing.count("syncs")
    wavs, aux = _synth("dap").synthesize(TEXTS, "spk")
    assert tracing.records() == []
    (wavs_t, aux_t), calls, _ = _traced(_synth("dap"))
    assert len(calls) == 1
    for a, b in zip(wavs, wavs_t):
        np.testing.assert_array_equal(a, b)
    for k in aux:
        np.testing.assert_array_equal(aux[k], aux_t[k])


class _Events:
    """Stands in for a span's pair of CUDA events: its host time."""

    def __init__(self, rec):
        self.ms = 1e3 * (rec["t1"] - rec["t0"])

    def elapsed_time(self, end):
        return self.ms


def _reader(name):
    from speedbench.metrics import reader
    return reader(name + ".offline")


@pytest.mark.parametrize("name", READERS)
def test_readers(name, monkeypatch):
    """Each reader returns its number from a recorded tiny call, the mean
    over the calls, and raises where a call lacks the span it reads."""
    (_, aux), calls, _ = _traced(_synth("dap"), n_calls=2)
    read = _reader(name)
    for recs in calls.values():
        for r in recs:
            r["ev"] = (_Events(r), None)
    value = read(None)
    assert value is not None and value > 0
    recs = list(calls.values())
    if name == "syncs":
        assert value == recs[0][-1]["counts"]["syncs"]
    elif name == "frontend_ms":
        want = np.mean([1e3 * (r["t1"] - r["t0"]) for c in recs for r in c
                        if r["name"] == "frontend"])
        assert value == pytest.approx(want)
    elif name == "flows_ms":
        want = np.mean([r["ev"][0].ms for c in recs for r in c
                        if r["name"] == "flows"])
        assert value == pytest.approx(want)
    else:
        want = np.mean([1e3 * sum(r["ev"][0].ms for r in c
                                  if r["name"] == "lstm")
                        / c[-1]["counts"]["lstm_steps"] for c in recs])
        assert value == pytest.approx(want)
    span = {"frontend_ms": "frontend", "syncs": None,
            "lstm_step_us": "lstm", "flows_ms": "flows"}[name]
    kept = [r for r in tracing.records() if r["name"] != span
            or r["call"] != recs[0][0]["call"]]
    if span is None:
        kept[-1]["counts"].pop("syncs")
    monkeypatch.setattr(tracing, "_records", kept)
    with pytest.raises(RuntimeError):
        read(None)


@pytest.mark.parametrize("name", READERS)
def test_readers_without_records(name, monkeypatch):
    """Nothing recorded (an untraced process) reads nothing; the parent
    program, without the module, neither."""
    import radtts_tpu_torch
    tracing.clear()
    assert _reader(name)(None) is None
    monkeypatch.setitem(sys.modules, "radtts_tpu_torch.tracing", None)
    monkeypatch.delattr(radtts_tpu_torch, "tracing")
    assert _reader(name)(None) is None


def test_readers_need_the_card_for_device_time():
    (_, _), calls, _ = _traced(_synth("dap"))
    assert _reader("flows_ms")(None) is None
    assert _reader("lstm_step_us")(None) is None


# -- on the card --------------------------------------------------------

SEED = 3000020017


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return "cuda"


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["dap_v1.offline_b16",
                                      "agap_v1.offline_b16"])
def test_syncs_are_what_cuda_reports(card, workload):
    """One warm call of the cell's configuration: PyTorch's sync debug
    mode warns once at each synchronizing operation; `syncs` counts
    every one."""
    from speedbench import traffic
    from speedbench.run import cell_spec, set_up
    spec = cell_spec(workload)
    _, synth, recorder, _ = set_up(spec, SEED, card,
                                   spec["config"]["matmul_precision"])
    recorder.uninstall()
    texts = traffic.closed_batches(spec["mix"], SEED)[0]
    tracing.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                synth.synthesize(texts, spec["mix"]["speaker"],
                                 **spec["mix"]["knobs"])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n_warned = sum("synchroniz" in str(w.message) for w in caught)
    (recs,) = tracing.calls().values()
    assert n_warned > 0
    assert recs[-1]["counts"]["syncs"] == n_warned


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["dap_v1.offline_b16",
                                      "agap_v1.offline_b16"])
def test_masked_lstms_take_the_kernel(card, workload):
    """One warm call of the cell's configuration: every masked LSTM run
    takes csrc/lstm.cu (counts lstm_kernel, none lstm_cudnn), and the call
    makes 8 syncs: the tokens and lengths up (2), the duration totals read
    and copied back (2), the outputs read (4); none of the LSTMs'."""
    from speedbench import traffic
    from speedbench.run import cell_spec, set_up
    spec = cell_spec(workload)
    _, synth, recorder, _ = set_up(spec, SEED, card,
                                   spec["config"]["matmul_precision"])
    recorder.uninstall()
    texts = traffic.closed_batches(spec["mix"], SEED)[0]
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        synth.synthesize(texts, spec["mix"]["speaker"],
                         **spec["mix"]["knobs"])
    (recs,) = tracing.calls().values()
    lstm = [r for r in recs if r["name"] == "lstm"]
    assert len(lstm) == _lstms_with_lengths(synth.model)
    assert all(r["counts"] == {"lstm_steps": r["counts"]["lstm_steps"],
                               "lstm_kernel": 1} for r in lstm)
    root = recs[-1]
    assert root["counts"]["lstm_kernel"] == len(lstm)
    assert root["counts"]["syncs"] == 8
    assert not [r for r in recs if r["name"] == "readback"
                and r["attrs"]["site"] == "lengths"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["dap_v1.offline_b16",
                                      "agap_v1.offline_b16"])
def test_traced_run_reads_the_program_spans(card, workload):
    """A traced benchmark run prints the four metrics that read the
    program's spans, is correct, and counts no radtts.* range as a
    kernel."""
    out = subprocess.run(
        [sys.executable, "-m", "speedbench", "--workload", workload,
         "--seed", str(SEED), "--seconds", "4", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    for name in READERS:
        assert line["metrics"][name + ".offline"]["value"] > 0, name
    assert not [n for n, _ in line["breakdown"]["device_ops"]
                if n.startswith(tracing.PREFIX)]
