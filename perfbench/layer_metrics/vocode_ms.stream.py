"""Median CUDA-event span of StreamingCloner._vocode (the step's Griffin-Lim
rounds) per steady step, ms."""

from benchlib.layers import span_median


def read(ctx):
    return span_median(ctx, "vocode")
