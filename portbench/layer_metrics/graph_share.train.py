"""The share of the traced steps that replayed a CUDA graph of the whole
step: the program's ``step_graph_replays`` counter
(``riggs_tpu_torch/train/step_graph.py``) over the traced window's steps.
None for a program without step graphs (an older commit)."""
import importlib.util

from portbench import spans


def read(ctx):
    if importlib.util.find_spec("riggs_tpu_torch.train.step_graph") is None:
        return None
    return spans.counter(ctx, "step_graph_replays")
