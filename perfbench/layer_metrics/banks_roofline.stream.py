"""Least time of the bank convolutions at their nonzero taps over their
CUDA-event spans (packed weight to batch norm), %."""

from benchlib.layers import banks_roofline as read  # noqa: F401
