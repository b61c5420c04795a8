"""Least time of the profiled batches' GRU scans (the encoder's and the
post-net's, both directions, H = 128, 6 T B H^2 FLOP a direction over the
sentences' own frames) over the device time of the kernels named gru_scan*, %."""

from benchlib.layers import scan_roofline as read  # noqa: F401
