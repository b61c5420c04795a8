"""Median CUDA-event span of ClonePipeline.device_predict (features, encoder,
decoder, stitch) per clip of the window, ms: the short clips' model share."""

from benchlib.layers import span_median


def read(ctx):
    return span_median(ctx, "predict")
