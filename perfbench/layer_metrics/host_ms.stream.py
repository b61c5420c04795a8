"""Median over steady steps of the step's host-clock time less its forward
and vocoder spans: numpy state, phase draws, crossfade, IIR, copy back, ms."""

from benchlib.layers import span_median


def read(ctx):
    return span_median(ctx, "host")
