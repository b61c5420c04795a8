"""Median CUDA-event span of StreamingCloner._forward (features at the
carried statistics, encoder, decoder) per steady step, ms."""

from benchlib.layers import span_median


def read(ctx):
    return span_median(ctx, "forward")
