"""Plain reference of the voice-conversion path, for the benchmark's check.

Plain PyTorch and NumPy, float32 with TF32 off unless a `Precision` asks
for less: the MFCC front end, the CBHG encoder and two-step decoder with a
GRU written as a loop over time and each bank convolution at its own
width, the two-pass window stitch, Griffin-Lim, and one step of a
streaming conversion from its carried state. It follows the published
description the program ports (socom20/speech-cloner: TF 'same' padding,
tf.contrib batch norm with eps 1e-3, GRUCell gates [r, u] with
c = tanh(W_c x + (r*h) W_c,h), librosa's STFT, mel and dB semantics) and
imports nothing of the program: every tensor it uses comes from the
benchmark (inputs, weight trees, phase draws) or is worked out here.
"""
