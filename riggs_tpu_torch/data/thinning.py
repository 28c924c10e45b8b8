"""Morphological skeleton thinning (Zhang-Suen), numpy only.

A copy of ``riggs_tpu/data/thinning.py``'s numpy path: the standard
two-subiteration Zhang-Suen thinning of a binary mask to a one-pixel-wide
skeleton, run once per frame while a scene is prepared. The reference's
optional C++ build of the same loop gives the same pixels.
"""
from __future__ import annotations

import numpy as np


def _neighbors(img: np.ndarray):
    """The 8 neighbors P2..P9 (clockwise from north) as shifted views."""
    p2 = np.roll(img, 1, 0)
    p3 = np.roll(np.roll(img, 1, 0), -1, 1)
    p4 = np.roll(img, -1, 1)
    p5 = np.roll(np.roll(img, -1, 0), -1, 1)
    p6 = np.roll(img, -1, 0)
    p7 = np.roll(np.roll(img, -1, 0), 1, 1)
    p8 = np.roll(img, 1, 1)
    p9 = np.roll(np.roll(img, 1, 0), 1, 1)
    return p2, p3, p4, p5, p6, p7, p8, p9


def zhang_suen_thin(mask: np.ndarray, max_iter: int = 200) -> np.ndarray:
    """Thin a binary mask to a 1-pixel-wide skeleton."""
    img = (np.asarray(mask) > 0.5).astype(np.uint8)
    img[0, :] = img[-1, :] = 0
    img[:, 0] = img[:, -1] = 0
    for _ in range(max_iter):
        changed = False
        for phase in (0, 1):
            p2, p3, p4, p5, p6, p7, p8, p9 = _neighbors(img)
            circle = [p2, p3, p4, p5, p6, p7, p8, p9, p2]
            B = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9
            A = sum(((circle[i] == 0) & (circle[i + 1] == 1)).astype(np.uint8) for i in range(8))
            if phase == 0:
                cond = (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
            else:
                cond = (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
            remove = (img == 1) & (B >= 2) & (B <= 6) & (A == 1) & cond
            if remove.any():
                img[remove] = 0
                changed = True
        if not changed:
            break
    return img.astype(bool)


def skeleton_pixels(mask: np.ndarray) -> np.ndarray:
    """(row, col) float32 coordinates of the thinned skeleton."""
    return np.argwhere(zhang_suen_thin(mask)).astype(np.float32)
