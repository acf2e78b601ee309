"""Per-layer metric readers: speedbench/metrics/<metric>.py, or for a
metric named <base>.<suffix> without a file of its own,
speedbench/metrics/<base>.py. Each defines read(run) -> number or None
(nothing to read: the metric is left out of the line). `run` is a
run.RunView: the recorded calls and spans, the reduced device trace, the
window, the configuration and the device's peaks.
"""

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name):
    """The read function of metric `name`."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                f"speedbench.metrics.{stem.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise FileNotFoundError(f"no reader for metric {name!r} in {HERE}")


def mean_span_ms(run, names, inside=None):
    """The mean over the window's calls of the device milliseconds of
    their spans named in `names` (only those nested in a span `inside`).
    Raises where a call has none: a missing span is a fault, never 0."""
    per = {d["idx"]: [] for d in run.window}
    for s in run.spans:
        if (s["name"] in names and s["dispatch"] in per
                and (inside is None or inside in s["parents"])):
            ms = run.device_ms(s)
            if ms is None:
                return None
            per[s["dispatch"]].append(ms)
    if not per:
        return None
    missing = [i for i, v in per.items() if not v]
    if missing:
        raise RuntimeError(f"calls {missing[:5]} have no span {names}")
    return sum(sum(v) for v in per.values()) / len(per)
