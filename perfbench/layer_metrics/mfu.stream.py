"""The window's encoder, decoder and vocoder work at the card's peaks over the
window's host seconds, %."""

from benchlib.layers import mfu as read  # noqa: F401
