"""Attribute predictors: the device milliseconds of the attribute spans
inside a call's decode (voicing, f0 and energy; the AGAP scans), the mean
over the window's calls."""

from speedbench.metrics import mean_span_ms


def read(run):
    return mean_span_ms(run, ("attributes",), inside="decode")
