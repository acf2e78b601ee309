"""Host-device syncs: the `syncs` count on a traced call's root span
(radtts_tpu_torch/tracing.py: every blocking transfer of the call, a
device-to-host read or a host-to-device copy from pageable memory), the
mean over the calls the profiler recorded. Nothing to read from a
program without its own spans."""


def read(run):
    try:
        from radtts_tpu_torch import tracing
    except ImportError:
        return None
    calls = tracing.calls()
    if not calls:
        return None
    total = 0
    for cid, recs in calls.items():
        n = recs[-1]["counts"].get("syncs")
        if n is None:
            raise RuntimeError(f"traced call {cid} counts no syncs")
        total += n
    return total / len(calls)
