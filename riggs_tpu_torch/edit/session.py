"""Stateful drag-keypoint ARAP editing session: the library behind the
viewer's editing endpoints.

Port of ``riggs_tpu/edit/session.py``: a sparse set of control points (FPS
samples of the cloud, or given nodes) carries an ARAP graph; ``pick``
selects the control point nearest a click in screen space; ``drag`` moves
the selected handle group in the camera's image plane; the local-global
ARAP solve (``edit/arap_deform.py``) repositions every control point, and
the dense cloud follows by Gaussian-kernel KNN blending of the control
points' displacements.

The control points, the blend and ``d_xyz`` live on the device: a drag
copies its handle targets over and reads nothing back, so the viewer
renders ``d_xyz`` next without a round trip. ``pick`` reads the projected
controls once per click (the argmin and the threshold are a host decision),
and ``drag`` reads the camera once. The keypoints themselves are host numpy,
as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import Camera, project_nodes_2d
from riggs_tpu_torch.device import constant, resolve_device
from riggs_tpu_torch.edit.arap_deform import deform_arap, make_deformer
from riggs_tpu_torch.edit.keypoints import DeformKeypoints
from riggs_tpu_torch.ops.fps import farthest_point_sample
from riggs_tpu_torch.ops.knn import knn


class EditSession:
    """Drag-editing state over a cloud ``gs_xyz`` (N, 3), on ``device`` (the
    card unless given), seeded with ``n_ctrl`` FPS samples or with
    ``ctrl_points``."""

    def __init__(self, gs_xyz, n_ctrl: int = 256, k_blend: int = 4, ctrl_points=None,
                 device: str | torch.device | None = None):
        dev = resolve_device(device)
        xyz = torch.as_tensor(gs_xyz, dtype=torch.float32, device=dev)
        if ctrl_points is not None:
            ctrl = torch.as_tensor(ctrl_points, dtype=torch.float32, device=dev)
        else:
            ctrl = xyz[farthest_point_sample(xyz, min(n_ctrl, xyz.shape[0])).to(torch.int64)]
        self.ctrl_rest = ctrl
        self.deformer = make_deformer(ctrl)
        d2, nn = knn(xyz, ctrl, k=min(k_blend, ctrl.shape[0]))
        # one radius for every control: the mean squared distance of the
        # cloud to its nearest control
        sigma2 = torch.maximum(torch.mean(d2, dim=0, keepdim=True)[..., :1], constant(1e-8, d2))
        w = torch.exp(-d2 / (2.0 * sigma2))
        self.blend_idx = nn.to(torch.int64)
        self.blend_w = w / torch.maximum(torch.sum(w, -1, keepdim=True), constant(1e-12, w))
        self.kps = DeformKeypoints()
        self.ctrl_cur = ctrl.clone()
        self.d_xyz = torch.zeros_like(xyz)

    # -- picking -----------------------------------------------------------
    def pick(self, cam: Camera, px: float, py: float, thresh_px: float = 25.0, expand: bool = False) -> int:
        """Select the control point nearest the clicked pixel (col=px, row=py).
        Returns the control index, or -1 if nothing is within ``thresh_px``."""
        rc = project_nodes_2d(cam, self.ctrl_cur)
        both = torch.cat([rc, self.ctrl_cur], dim=-1).cpu().numpy()  # one read
        rc, cur = both[:, :2], both[:, 2:]
        d = np.hypot(rc[:, 0] - py, rc[:, 1] - px)
        i = int(np.argmin(d))
        if d[i] > thresh_px:
            return -1
        self.kps.add_kpts(cur[i], i, expand=expand)
        return i

    # -- dragging ----------------------------------------------------------
    def drag(self, cam: Camera, dpx: float, dpy: float) -> None:
        """Move the selected handle group by a screen-space delta (pixels),
        mapped to world units in the camera's image plane at the handle depth,
        then re-solve ARAP and re-blend."""
        sel = self.kps.get_selective_keypoints_idx()
        if not sel:
            return
        host = torch.cat([cam.w2c.reshape(-1), cam.intrinsics]).cpu().numpy()  # one read
        w2c, intr = host[:16].reshape(4, 4), host[16:]
        R = w2c[:3, :3]  # rows: the camera's x, y, z axes in world
        anchor = np.mean([self.kps.keypoints[i] for i in self.kps.selective_keypoints_idx_list], axis=0)
        depth = float((anchor[None] @ R.T + w2c[:3, 3])[0, 2])
        scale = max(depth, 1e-6)
        delta = R[0] * (dpx * scale / float(intr[0])) + R[1] * (dpy * scale / float(intr[1]))
        self.kps.update_selective_keypoints(delta)
        self.solve()

    def solve(self) -> None:
        """Solve for the current handle targets; ``ctrl_cur`` and ``d_xyz``
        stay on the device."""
        dev = self.ctrl_rest.device
        idxs = torch.as_tensor(np.asarray(self.kps.get_kpt_idx(), np.int32), device=dev)
        pos = torch.as_tensor(np.asarray(self.kps.get_kpt(), np.float32).reshape(-1, 3), device=dev)
        self.ctrl_cur, _rot = deform_arap(self.deformer, idxs, pos)
        disp = self.ctrl_cur - self.ctrl_rest  # (M, 3)
        self.d_xyz = torch.einsum("nk,nkd->nd", self.blend_w, disp[self.blend_idx])

    def clear(self) -> None:
        self.kps.clear()
        self.ctrl_cur = self.ctrl_rest.clone()
        self.d_xyz = torch.zeros_like(self.d_xyz)
