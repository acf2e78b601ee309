"""Vocoder: the device milliseconds of a call's vocoder and denoiser
spans, the mean over the window's calls."""

from speedbench.metrics import mean_span_ms


def read(run):
    return mean_span_ms(run, ("vocoder", "denoiser"))
