"""Recurrent layers: the device microseconds of a traced call's `lstm`
spans (radtts_tpu_torch/ops/lstm.py, the CUDA events around each
recurrent run) over the call's `lstm_steps` (padded time steps x
directions x layers), the mean over the calls the profiler recorded.
Nothing to read from a program without its own spans, or off the card."""

import torch


def read(run):
    try:
        from radtts_tpu_torch import tracing
    except ImportError:
        return None
    calls = tracing.calls()
    if not calls:
        return None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    total = 0.0
    for cid, recs in calls.items():
        spans = [r for r in recs if r["name"] == "lstm"]
        steps = recs[-1]["counts"].get("lstm_steps")
        if not spans or not steps:
            raise RuntimeError(f"traced call {cid} has no lstm span")
        ms = [tracing.device_ms(r) for r in spans]
        if None in ms:
            return None
        total += 1e3 * sum(ms) / steps
    return total / len(calls)
