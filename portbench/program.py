"""The system under test, ``riggs_tpu_torch``, built from the harness's
seeded inputs: its Gaussians, its SkeletonWarp with the harness's weights,
its Config, its cameras and frames; and a capture of what its timed entry
produced (the deformation and the render), for the comparison with the
reference after the window.
"""
from __future__ import annotations

import contextlib
import json

import numpy as np
import torch

from portbench import scene


def config(cfg: dict):
    from riggs_tpu_torch.train.config import Config

    return Config.from_json(json.dumps(cfg["riggs"]))


def gaussians(avatar: dict, sh_degree: int):
    """The program's Gaussians on copies of the harness's tensors."""
    from riggs_tpu_torch.models.gaussians import Gaussians

    p = {k: v.clone() for k, v in avatar["params"].items()}
    return Gaussians(xyz=p["xyz"], features_dc=p["f_dc"], features_rest=p["f_rest"], scaling=p["scaling"],
                     rotation=p["rotation"], opacity=p["opacity"], feature=p["feature"],
                     alive=avatar["alive"].clone(), max_sh_degree=sh_degree, isotropic=False, with_motion_mask=True)


def skeleton(joints: torch.Tensor, weights: dict, cfg: dict, device):
    """The program's SkeletonWarp at the configuration's widths, its
    parameters overwritten with the harness's weights."""
    from riggs_tpu_torch.models.skeleton_warp import init_skeleton_warp

    s = cfg["skeleton"]
    skel = init_skeleton_warp(joints.cpu().numpy(), scene.PARENTS, K=s["knn"], use_skinning_mlp=True,
                              use_template_offsets=True, n_control_nodes=cfg["riggs"]["model"]["skeleton_gs_sample_num"],
                              generator=torch.Generator(device=device).manual_seed(0), device=device)
    net = skel.net
    widths = (net.pose_width, net.pose_depth, net.pose_multires, net.weight_multires, net.detail_multires_x)
    if widths != (s["width"], s["depth"], s["pose_multires"], s["weight_multires"], s["detail_multires"]):
        raise ValueError(f"the program's skeleton widths {widths} are not the configuration's {s}")
    return skel.replace_params(weights)


def camera(frames: scene.Frames, i: int):
    from riggs_tpu_torch.camera.camera import Camera

    return Camera(w2c=frames.w2c[i], intrinsics=frames.intrinsics[i], fid=frames.fid[i], width=frames.width,
                  height=frames.height)


def train_frames(frames: scene.Frames) -> list:
    from riggs_tpu_torch.data.dataset import Frame

    return [Frame(cam=camera(frames, i), image=frames.image[i], alpha_mask=frames.alpha[i],
                  thinned=frames.thinned[i], thinned_mask=frames.thinned_mask[i]) for i in range(frames.fid.shape[0])]


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.detach().clone()


DEFORM_KEYS = ("d_xyz", "d_rotation", "d_nodes", "template_offsets", "local_rotation", "global_trans")
RENDER_KEYS = ("render", "alpha", "depth")


class Capture:
    """While ``armed``, keeps a copy of what the program's functions in
    ``targets`` ({name: (module, attribute, keys)}) return, under
    ``records[name]``: the deformation and the render of the timed entry
    itself, as it produced them."""

    def __init__(self, targets: dict):
        self.targets = targets
        self.armed = False
        self.records: dict[str, list] = {name: [] for name in targets}

    def _wrap(self, name, fn, keys):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            if self.armed:
                self.records[name].append({k: out[k].detach().clone() for k in keys})
            return out
        return wrapped

    @contextlib.contextmanager
    def installed(self):
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in self.targets.values()]
        for name, (mod, attr, keys) in self.targets.items():
            setattr(mod, attr, self._wrap(name, getattr(mod, attr), keys))
        try:
            yield self
        finally:
            for mod, attr, fn in reversed(saved):
                setattr(mod, attr, fn)


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b| (the reference's scale), 0 for two zeros."""
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    return err / scale if scale > 0 else err


def p999_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The 99.9th percentile of |a - b| over max |b|: blind to the few
    pixels where a rounding puts a Gaussian across the alpha threshold, a
    positive power or another's depth (each a gap of up to the Gaussian's
    whole colour, at a pixel or two), not to a tile (1024 pixels) gone wrong."""
    err = (a - b).abs().flatten()
    k = max(1, -(-999 * err.numel() // 1000))
    q = float(torch.kthvalue(err.cpu(), k).values)
    scale = float(b.abs().max())
    return q / scale if scale > 0 else q


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Per leaf, |norm(program) - norm(reference)| over the larger of the
    reference's norm of that leaf and its median leaf's norm."""
    norms = {k: float(torch.linalg.norm(ref[k])) for k in ref}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(torch.linalg.norm(prog[k])) - norms[k]) / max(norms[k], med, 1e-30)
            for k in ref if keep is None or k in keep}


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap (``leaf_gaps``) and its name."""
    gaps = leaf_gaps(prog, ref, keep)
    which = max(gaps, key=gaps.get)
    return gaps[which], which


def median_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The median leaf's gap (``leaf_gaps``)."""
    return float(np.median(list(leaf_gaps(prog, ref, keep).values())))
