"""Decoder flows: the device milliseconds of a traced call's `flows` span
(radtts_tpu_torch/models/radtts.py:radtts_infer, the CUDA events around
the inverse flows: the WN couplings and the 1x1 inverses), the mean over
the calls the profiler recorded. Nothing to read from a program without
its own spans, or off the card."""

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
        spans = [r for r in recs if r["name"] == "flows"]
        if not spans:
            raise RuntimeError(f"traced call {cid} has no flows span")
        ms = [tracing.device_ms(r) for r in spans]
        if None in ms:
            return None
        total += sum(ms)
    return total / len(calls)
