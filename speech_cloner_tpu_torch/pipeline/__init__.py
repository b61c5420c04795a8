"""End-to-end clone pipeline (counterpart of speech_cloner_tpu/pipeline)."""

from .clone import ClonePipeline, make_pipeline
from .stitch import compound, pad_to_multiple, shifted_window_stack, stitch_single, window_stack
from .stream import StreamingCloner

__all__ = ["ClonePipeline", "StreamingCloner", "compound", "make_pipeline", "pad_to_multiple",
           "shifted_window_stack", "stitch_single", "window_stack"]
