"""Median device ms of the program's span vocode (the ragged batch's
Griffin-Lim, each sentence at its own frame count) per batch of the window."""

from benchlib.tacotron import program_span_median


def read(ctx):
    return program_span_median(ctx, "vocode")
