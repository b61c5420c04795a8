"""Least time of the encoder's and the post-net's bank convolutions at their
nonzero taps, over the sentences' own frames, over their CUDA-event spans
(packed weight to batch norm), %."""

from benchlib.layers import banks_roofline as read  # noqa: F401
