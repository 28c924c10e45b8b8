"""Optical-flow (RAFT) supervision for stage 1's phase B.

Port of ``riggs_tpu/data/flow.py``. ``raft_neighbouring/<image_name>.
<suffix>_<partner_name>.npy`` holds the (H', W', 2) pixel flow from a train
frame to a neighbouring frame, ``raft_masks/<same>.png`` its validity
channels [cycle-consistency, occlusion, ...]. One candidate of the frame is
drawn each step from the loop's numpy generator, as the reference draws it.

Unlike the reference, which loads and resizes the drawn file every step,
``FlowStore`` reads and resizes every candidate once, at construction, onto
the frames' device (the same numpy arithmetic, so the same values): a step
draws a prepared tensor and copies nothing from the host. A scene's flows
then take 12 bytes a pixel a candidate of device memory. PIL reads the
masks.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from riggs_tpu_torch.device import resolve_device


def _resize_bilinear(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, C) -> (h, w, C) bilinear with half-pixel centres, in numpy
    (the reference's own arithmetic)."""
    H, W = arr.shape[:2]
    if (H, W) == (h, w):
        return arr
    ys = (np.arange(h) + 0.5) * H / h - 0.5
    xs = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = arr[np.ix_(y0, x0)]
    b = arr[np.ix_(y0, x1)]
    c = arr[np.ix_(y1, x0)]
    d = arr[np.ix_(y1, x1)]
    return (
        a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx
    ).astype(arr.dtype)


class FlowStore:
    """Each train frame's flow candidates, prepared on ``device``.

    ``image_names``, ``fids`` and ``sizes`` ((height, width)) are the train
    frames', in order. ``sample(i, rng)`` draws one of frame i's candidates;
    ``no_partner(frame)`` is what a step without a partner carries."""

    def __init__(self, source_path: str | Path, image_names: list[str], fids: list[float],
                 sizes: list[tuple[int, int]], device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.flow_dir = Path(source_path) / "raft_neighbouring"
        self.mask_dir = Path(source_path) / "raft_masks"
        self.fid_by_name = dict(zip(image_names, fids))
        entries = sorted(self.flow_dir.iterdir()) if self.flow_dir.exists() else []
        # candidates[i] = the flow files whose name starts with "<image_name>."
        self.candidates: list[list[Path]] = [
            [e for e in entries if e.name.startswith(name + ".")] for name in image_names
        ]
        self.prepared = [[self._prepare(p, h, w) for p in cands] for cands, (h, w) in zip(self.candidates, sizes)]
        self._zeros: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}

    def has_flow(self, i: int) -> bool:
        return bool(self.candidates[i])

    def partner_name(self, flow_path: Path) -> str | None:
        """The partner frame's name in a flow file's name: the longest known
        image name its tail ends with (names may hold underscores, as
        D-NeRF's 'r_000' do), else its last '_'-token as the reference's
        original loader takes it."""
        stem = flow_path.stem  # "<image_name>.<suffix>_<partner>"
        tail = stem.split(".", 1)[1] if "." in stem else stem
        matches = [n for n in self.fid_by_name if tail.endswith(n)]
        if matches:
            return max(matches, key=len)
        return stem.split("_")[-1]

    def _prepare(self, pick: Path, height: int, width: int):
        """(flow (H, W, 2) px, validity (H, W), partner fid ()) on the device,
        or None when the partner frame is unknown."""
        from PIL import Image

        partner = self.partner_name(pick)
        if partner not in self.fid_by_name:
            return None
        flow = np.load(pick).astype(np.float32)
        mask_path = self.mask_dir / pick.name.replace(".npy", ".png")
        if mask_path.exists():
            masks = np.asarray(Image.open(mask_path), np.float32) / 255.0
            if masks.ndim == 2:
                masks = masks[..., None].repeat(2, axis=-1)
        else:
            masks = np.ones(flow.shape[:2] + (2,), np.float32)
        flow = _resize_bilinear(flow, height, width)
        masks = _resize_bilinear(masks, height, width)
        # valid where cycle-consistent or occlusion-flagged
        valid = ((masks[..., 0] > 0) | (masks[..., 1] > 0)).astype(np.float32)
        to = lambda a: torch.as_tensor(a).to(self.device)
        return to(flow), to(valid), to(np.float32(self.fid_by_name[partner]))

    def sample(self, i: int, rng: np.random.Generator):
        """A random candidate of train frame i: (flow, validity, partner
        fid), or None when the frame has no candidate (no draw) or the drawn
        one's partner is unknown."""
        cands = self.prepared[i]
        if not cands:
            return None
        return cands[rng.integers(len(cands))]

    def no_partner(self, frame):
        """A step that draws no partner: zero flow and validity (the flow
        term is then exactly 0) and the frame's own time."""
        key = (frame.cam.height, frame.cam.width)
        if key not in self._zeros:
            self._zeros[key] = (torch.zeros(key + (2,), device=self.device), torch.zeros(key, device=self.device))
        return (*self._zeros[key], frame.fid)
