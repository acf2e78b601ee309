"""Text frontend: the host milliseconds of a traced call's `frontend` span
(radtts_tpu_torch/synthesizer.py: the texts encoded and padded, the
tokens copied to the card), the mean over the calls the profiler
recorded (radtts_tpu_torch/tracing.py). Nothing to read from a program
without its own spans."""


def read(run):
    try:
        from radtts_tpu_torch import tracing
    except ImportError:
        return None
    calls = tracing.calls()
    if not calls:
        return None
    total = 0.0
    for cid, recs in calls.items():
        spans = [r for r in recs if r["name"] == "frontend"]
        if not spans:
            raise RuntimeError(f"traced call {cid} has no frontend span")
        total += sum(1e3 * (r["t1"] - r["t0"]) for r in spans)
    return total / len(calls)
