"""Median device ms of the program's span tts.decode (the free-running
decoder loop over the batch's longest sentence) per batch of the window."""

from benchlib.tacotron import program_span_median


def read(ctx):
    return program_span_median(ctx, "tts.decode")
