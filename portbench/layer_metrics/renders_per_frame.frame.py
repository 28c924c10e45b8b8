"""Renders a frame: the program's ``frame_renders`` counter (each render
``FrameHolder`` makes, ``riggs_tpu_torch/trace.py``) over the traced frames;
1 when every frame is held by its first render."""
from portbench import spans


def read(ctx):
    return spans.counter(ctx, "frame_renders")
