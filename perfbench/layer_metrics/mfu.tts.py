"""The window's encoder, decoder-step, post-net and vocoder work
(benchlib/tacotron.py, each sentence at its own length) at the card's
peaks over the window's host seconds, %."""

from benchlib.layers import mfu as read  # noqa: F401
