"""Device us of the program's span tts.decode over its counter
tts.decode_steps, the window's whole: the time of one decoder step of the
batch."""

from benchlib.tacotron import per_count_us


def read(ctx):
    return per_count_us(ctx, "tts.decode", "tts.decode_steps")
