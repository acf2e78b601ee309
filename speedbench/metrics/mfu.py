"""The whole synthesis step's share of the device's peak: the model FLOP
of the window's completed texts (speedbench/flops.py, at each text's own
token and frame counts) over the window's seconds times the TF32 peak."""

from speedbench.flops import synthesis_flops


def read(run):
    if not run.window or run.peaks is None:
        return None
    mc, h = run.config["model_config"], run.config["vocoder"]["config"]
    total = 0
    for d in run.window:
        for n_tokens, n_frames in zip(d["n_tokens"], d["aux"]["n_frames"]):
            total += synthesis_flops(mc, h, n_tokens, int(n_frames))
    return 100.0 * total / (run.window_s * run.peaks["tf32_flops"])
