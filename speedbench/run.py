"""The benchmark of radtts_tpu_torch on one card.

    python3 -m speedbench --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One run is one process: it makes the cell's weights on the card from the
seed, builds the program, warms the cell's own shapes, drives the cell's
traffic through the program's entry for `--seconds`, checks a sample of
what it produced against the plain reference, and prints one JSON line
last on standard output (the numbers compared, each beside its limit,
last on standard error too). --trace 1 also records spans and a device
trace and prints the cell's per-layer metrics instead of its end-to-end
ones.

A cell is an entry of BENCHMARK.json's workloads: a configuration
(speedbench/configs/<config>.json) under a traffic mix
(speedbench/traffic/<traffic>.json); its metrics are the entries of
BENCHMARK.json that list it, each read by speedbench/metrics/.
"""

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "radtts_tpu")
DEFAULT_TRACE_CALLS = 2


def process_age():
    """Seconds since this process started (Linux), else None."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


_T_IMPORT = time.perf_counter()
_AGE_AT_IMPORT = process_age()


def setup_seconds():
    """Process start to now."""
    base = _AGE_AT_IMPORT if _AGE_AT_IMPORT is not None else 0.0
    return base + time.perf_counter() - _T_IMPORT


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(name, benchmark=None):
    """The cell `name` of BENCHMARK.json with its configuration, mix and
    the metrics that list it."""
    from speedbench import traffic
    bench = benchmark or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"speedbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell,
            "config": load_json(os.path.join(ROOT, config["file"])),
            "mix": traffic.load_mix(cell["traffic"]),
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


class RunView:
    """What a metric reader reads (see speedbench/metrics/)."""

    def __init__(self, spec, recorder, trace, window_s, peaks,
                 traced_dispatches, encode):
        self.config = spec["config"]
        self.spans = recorder.spans
        self.device_ms = recorder.device_ms
        self.window = recorder.window()
        for d in self.window:
            d.setdefault("n_tokens", [len(encode(t)) for t in d["texts"]])
        self.trace = trace
        self.window_s = window_s
        self.peaks = peaks
        self.traced_dispatches = traced_dispatches


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _trace_block(traced, device):
    if not traced or not device.startswith("cuda"):
        return None
    from speedbench.trace import DeviceTrace
    return DeviceTrace()


def run_closed(synth, mix, recorder, seed, seconds, traced, device):
    from speedbench import traffic
    batches = traffic.closed_batches(mix, seed)
    knobs, speaker = mix["knobs"], mix["speaker"]
    n_trace = mix.get("trace_calls", DEFAULT_TRACE_CALLS)
    tracer = _trace_block(traced, device)
    traced_idx = set()
    recorder.phase = "window"
    t0 = time.perf_counter()
    if tracer is not None:
        tracer.mark()
    k = 0
    audio = 0
    while time.perf_counter() - t0 < seconds:
        wavs, _ = synth.synthesize(batches[k % len(batches)], speaker,
                                   **knobs)
        audio += sum(len(w) for w in wavs)
        k += 1
        if tracer is not None and k == n_trace:
            tracer.stop()
            traced_idx = {d["idx"] for d in recorder.window()}
    _sync(device)
    t1 = time.perf_counter()
    if tracer is not None and k < n_trace:
        tracer.stop()
        traced_idx = {d["idx"] for d in recorder.window()}
    trace = tracer.reduce() if tracer is not None else None
    recorder.phase = "after"
    sr = synth.sampling_rate
    return {"t0": t0, "t1": t1, "attempted": sum(
                len(batches[i % len(batches)]) for i in range(k)),
            "failed": 0, "audio_s": audio / sr, "trace": trace,
            "traced": traced_idx}


def end_to_end(window, setup_s):
    return {"setup_s": setup_s,
            "audio_s_per_s": window["audio_s"] / (window["t1"] - window["t0"])}


def card_power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def set_up(spec, seed, device, precision, traced=False, hook=None):
    """The cell's seeded weights, its system with every call recorded, and
    its shapes warmed: (weights, synth, recorder, set-up phases)."""
    from speedbench import system, traffic
    from speedbench.calibrate import calibrate
    from speedbench.reference import radtts as ref
    from speedbench.reference.text import TextProcessing as RefText
    from speedbench.spans import Recorder
    from speedbench.weights import make_weights

    config, mix = spec["config"], spec["mix"]
    mc, h = config["model_config"], config["vocoder"]["config"]
    phases = {"imports": setup_seconds()}
    tic = time.perf_counter()
    weights = make_weights(ref.parameter_specs(mc, h), seed, device,
                           config["assumed"]["init"])
    _sync(device)
    phases["weights"] = time.perf_counter() - tic
    calibrate(weights, config, device,
              system.text_processing(RefText, config["data_config"]), seed)
    _sync(device)
    phases["calibration"] = time.perf_counter() - tic - phases["weights"]
    tic = time.perf_counter()
    synth = system.build(config, weights, device, precision)
    phases["build"] = time.perf_counter() - tic
    tic = time.perf_counter()
    recorder = Recorder(seed, traced, device)
    recorder.install(synth)
    if hook is not None:
        hook(synth)
    recorder.phase = "warmup"
    for texts in traffic.closed_batches(mix, seed):
        synth.synthesize(texts, mix["speaker"], **mix["knobs"])
    _sync(device)
    phases["warmup"] = time.perf_counter() - tic
    gc.collect()        # the set-up's garbage, not the window's
    return weights, synth, recorder, phases


def run_cell(spec, seed, seconds, traced, device="cuda", control=False,
             hook=None):
    """One run of a cell: the result line's dict. `control` runs the
    program at its TF32 precision (the control that the checks must
    refuse); `hook(synth)`, for tests, may break the timed path."""
    import torch

    from speedbench import check, system
    from speedbench.peaks import peaks
    from speedbench.reference.text import TextProcessing as RefText

    config, mix = spec["config"], spec["mix"]
    precision = "default" if control else config["matmul_precision"]
    weights, synth, recorder, phases = set_up(spec, seed, device, precision,
                                              traced, hook)
    setup_s = setup_seconds()
    win = run_closed(synth, mix, recorder, seed, seconds, traced, device)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    result_device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if on_card else 0),
    }
    recorder.uninstall()
    metrics = {}
    e2e = end_to_end(win, setup_s)
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    breakdown = None
    if traced:
        pk = peaks(result_device["kind"]) if on_card else None
        ref_tp = system.text_processing(RefText, config["data_config"])
        view = RunView(spec, recorder, win["trace"], win["t1"] - win["t0"],
                       pk, win["traced"], ref_tp.encode_text)
        from speedbench.metrics import reader
        for m in spec["per_layer"]:
            value = reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if win["trace"] is not None:
            result_device["busy_s"] = win["trace"]["busy_s"]
            result_device["window_s"] = win["trace"]["window_s"]
            breakdown = {k: win["trace"][k] for k in ("device_ops",
                                                      "idle_gaps")}
    else:
        for m in spec["end_to_end"]:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": units[m["name"]]}
    if on_card:
        result_device["power_limit"] = card_power_limit()
    window = recorder.window()
    del synth
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, ok, n_checked, others = check.check(
        config, weights, device, window, mix["check"]["dispatches"], seed)
    result = {"correct": bool(ok and win["failed"] == 0),
              "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window"] = {"seconds": win["t1"] - win["t0"],
                        "calls": len(window), "calls_checked": n_checked,
                        "call_ms": _call_ms(window),
                        "setup_phases_s": phases,
                        "not_compared": others,
                        "end_to_end": e2e if traced else None}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def _call_ms(window):
    """Host milliseconds of the window's synthesize calls: median, max."""
    ms = sorted(1e3 * (d["t1"] - d["t0"]) for d in window)
    return {"median": statistics.median(ms), "max": ms[-1]} if ms else None


def forbidden_modules():
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m speedbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="run the program at TF32 (the control); never in "
                        "the benchmark's own runs")
    args = p.parse_args(argv)
    spec = cell_spec(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("speedbench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["cell"]["chips"]:
        print(f"speedbench: {spec['cell']['chips']} cards needed, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      control=bool(args.control))
    found = forbidden_modules()
    if found:
        print(f"speedbench: loaded {found} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
