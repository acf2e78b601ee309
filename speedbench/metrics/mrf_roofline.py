"""The MRF kernels' share of their roofline in the traced calls: the least
time of the MRF work those calls asked for (speedbench/flops.py:mrf_stage
at each item's own sample count: FLOP at the TF32 peak against the bytes
at the HBM rate, the larger) over the device time of the kernels inside
the calls' mrf spans (the trace's device-side ranges of the spans)."""

from speedbench.flops import mrf_stage


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    calls = [s for s in run.spans if s["name"] == "mrf"
             and s["dispatch"] in run.traced_dispatches]
    if not calls:
        return None
    rates = run.config["vocoder"]["config"]["upsample_rates"]
    by_call = {d["idx"]: d for d in run.window}
    bound = 0.0
    for s in calls:
        d = by_call[s["dispatch"]]
        B, T, C = s["shape"]
        up = 1
        for u in rates[:_stage(run, C) + 1]:
            up *= u
        samples = sum(int(n) * up for n in d["aux"]["n_frames"])
        flop, nbytes = mrf_stage(samples, C, s["kernel_sizes"])
        bound += max(flop / run.peaks["tf32_flops"],
                     nbytes / run.peaks["hbm_bytes"])
    device_s = run.trace["span_device_s"].get("mrf")
    if not device_s:
        raise RuntimeError("the trace has no device time inside mrf spans")
    return 100.0 * bound / device_s


def _stage(run, C):
    ch0 = run.config["vocoder"]["config"]["upsample_initial_channel"]
    return {ch0 // 2 ** (i + 1): i for i in range(8)}[C]
