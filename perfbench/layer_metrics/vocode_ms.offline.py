"""Median CUDA-event span of ClonePipeline.device_vocode_pcm16 (Griffin-Lim,
STFTs, inverse pre-emphasis, PCM) per clip of the window, ms."""

from benchlib.layers import span_median


def read(ctx):
    return span_median(ctx, "vocode")
