"""Text to mel: the device milliseconds of a call's durations and decode
spans (infer_durations, radtts_infer), the mean over the window's calls."""

from speedbench.metrics import mean_span_ms


def read(run):
    return mean_span_ms(run, ("durations", "decode"))
