"""Faults planted in the program under test, for the check's own tests:
each must make a run's ``correct`` come out false.

``frozen``: a training step (stage 2's or phase B's) returns the state it
was given (its skeleton or node warp put back as it was), with the step's
metrics. ``tile``: the frame a render
produces has the 32 x 32 tile at its centre inverted (1 - v), where it is
produced, as a blend that mixed up one tile would leave it.
"""
from __future__ import annotations

import contextlib

import torch

TILE = 32
FAULTS = ("frozen", "tile")


def _frozen(step, model):
    """``step`` returning the state it was given, the model's parameters
    (updated in place by the step) put back, with the step's metrics."""
    def frozen(state, *a, **kw):
        before = [p.detach().clone() for p in model(state).parameters()]
        _, metrics = step(state, *a, **kw)
        with torch.no_grad():
            for p, b in zip(model(state).parameters(), before):
                p.copy_(b)
        return state, metrics
    return frozen


def _tiled(render):
    """``render`` with the 32 x 32 tile at the frame's centre inverted."""
    def altered(*a, **kw):
        out = dict(render(*a, **kw))
        img = out["render"]
        tile = torch.zeros(img.shape[:2] + (1,), dtype=torch.bool, device=img.device)
        h, w = img.shape[0] // 2, img.shape[1] // 2
        tile[h:h + TILE, w:w + TILE] = True
        out["render"] = torch.where(tile, 1.0 - img, img)
        return out
    return altered


@contextlib.contextmanager
def planted(fault: str):
    from riggs_tpu_torch.train import stage1 as S1
    from riggs_tpu_torch.train import stage2 as S2
    from riggs_tpu_torch.viz import web_viewer as WV

    saved = [(S2, "stage2_step"), (S1, "phase_b_step"), (S2, "render"), (S1, "render"), (WV, "render")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    if fault == "frozen":
        S2.stage2_step = _frozen(S2.stage2_step, lambda st: st.skel)
        S1.phase_b_step = _frozen(S1.phase_b_step, lambda st: st.warp)
    elif fault == "tile":
        for mod in (S2, S1, WV):
            mod.render = _tiled(mod.render)
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
