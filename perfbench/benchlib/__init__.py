"""The benchmark's own library: finding cells by name, weights and audio
from the seed, work counts and peaks, tracing, and the output comparison.

Imports nothing of the program at module level; the drivers under
``traffic/`` import the program (``speech_cloner_tpu_torch``) when a cell runs.
"""
