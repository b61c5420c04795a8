"""Least time of the profiled units' GRU scans (6 T B H^2 FLOP a direction, or
their bytes, at the compute type's peak) over the device time of the
kernels named gru_scan*, %."""

from benchlib.layers import scan_roofline as read  # noqa: F401
