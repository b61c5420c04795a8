"""Share of the profiled window in which no operation ran on the device
(union of the device's intervals), %."""

from benchlib.layers import idle_share as read  # noqa: F401
