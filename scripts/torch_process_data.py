#!/usr/bin/env python3
"""Offline dataset preprocessing on the PyTorch port's host code (the twin of
scripts/process_data.py, with the same subcommands and flags).

    python scripts/torch_process_data.py thin --path <scene> [--images train]
    python scripts/torch_process_data.py semseg --path <scene> [--parts 8]
    python scripts/torch_process_data.py zju-cams --path <subject> [--frames 300]
    python scripts/torch_process_data.py smpl-prior --path <subject> --vertices <dir of .npy/.npz>

  thin        2D skeletons (train_thinned/<name>_thinned.png) from the alpha
              channels or masks, by the port's numpy Zhang-Suen
              (``data/thinning.py``) where the reference calls its C++ build
              of the same loop (the same pixels)
  semseg      part labels (semantic_seg/<name>_seg.npy) by k-means over pixel
              position and colour
  zju-cams    interleave a ZJU subject's rotating train cameras: frame i
              takes camera i mod the number of views
  smpl-prior  posed SMPL vertices per frame -> SMPL_prior/*.npy
Host numpy and PIL only: nothing here runs on the card.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
from PIL import Image

from riggs_tpu_torch.data.thinning import zhang_suen_thin


def cmd_thin(args):
    src = Path(args.path)
    out = src / "train_thinned"
    out.mkdir(exist_ok=True)
    images = sorted((src / args.images).glob("*.png"))
    for p in images:
        im = np.asarray(Image.open(p).convert("RGBA"), np.float32) / 255.0
        mask = im[..., 3] if im.shape[-1] == 4 else (im[..., :3].sum(-1) > 0.05)
        sk = zhang_suen_thin(mask)
        Image.fromarray((sk * 255).astype(np.uint8)).save(out / f"{p.stem}_thinned.png")
        print(p.stem, int(sk.sum()), "skeleton px")


def kmeans_semantic_seg(im, parts: int, spatial_weight: float = 1.0):
    """(H, W, 3|4) float image -> (H, W) int64 part labels (0 = background):
    k-means over (y, x, r, g, b) pixel features, seeded, 15 rounds (the
    stand-in for DINO-ViT feature clustering, whose weights are not
    available offline)."""
    h, w = im.shape[:2]
    mask = im[..., 3] > 0.5 if im.shape[-1] == 4 else im[..., :3].sum(-1) > 0.05
    ys, xs = np.nonzero(mask)
    seg = np.zeros((h, w), np.int64)
    if len(ys) == 0:
        return seg
    feats = np.stack(
        [ys / h, xs / w, im[ys, xs, 0], im[ys, xs, 1], im[ys, xs, 2]], -1
    )
    feats[:, :2] *= spatial_weight
    rng = np.random.default_rng(0)
    centers = feats[rng.choice(len(feats), parts, replace=False)]
    for _ in range(15):
        d = ((feats[:, None] - centers[None]) ** 2).sum(-1)
        lab = d.argmin(1)
        for j in range(parts):
            sel = lab == j
            if sel.any():
                centers[j] = feats[sel].mean(0)
    seg[ys, xs] = lab + 1
    return seg


def cmd_semseg(args):
    src = Path(args.path)
    out = src / "semantic_seg"
    out.mkdir(exist_ok=True)
    images = sorted((src / args.images).glob("*.png"))
    for p in images:
        im = np.asarray(Image.open(p).convert("RGBA"), np.float32) / 255.0
        seg = kmeans_semantic_seg(im, args.parts, args.spatial_weight)
        np.save(out / f"{p.stem}_seg.npy", seg[None])
        print(p.stem, "parts:", args.parts)


def cmd_zju_cams(args):
    """Interleave rotating train views: frame i uses camera (i % n_views)
    (construct_zju_train_cam.py:8-62 behavior)."""
    import pickle

    src = Path(args.path)
    views = sorted((src / "views").glob("view_*/cameras.pkl"))
    all_cams = {}
    per_view = []
    for v in views:
        with open(v, "rb") as f:
            per_view.append(pickle.load(f))
    n_views = len(per_view)
    n_frames = args.frames
    for i in range(n_frames):
        vi = i % n_views
        keys = sorted(per_view[vi])
        src_key = keys[i % len(keys)]
        all_cams[f"frame_{i:06d}"] = per_view[vi][src_key]
    with open(src / "train" / "cameras.pkl", "wb") as f:
        pickle.dump(all_cams, f)
    print(f"wrote {len(all_cams)} interleaved cameras from {n_views} views")


def cmd_smpl_prior(args):
    src = Path(args.path)
    out = src / "SMPL_prior"
    out.mkdir(exist_ok=True)
    for p in sorted(Path(args.vertices).glob("*.np[yz]")):
        data = np.load(p)
        verts = data["vertices"] if hasattr(data, "files") else data
        np.save(out / f"{p.stem}.npy", np.asarray(verts, np.float32))
        print(p.stem, verts.shape)


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("thin")
    t.add_argument("--path", required=True)
    t.add_argument("--images", default="train")
    s = sub.add_parser("semseg")
    s.add_argument("--path", required=True)
    s.add_argument("--images", default="train")
    s.add_argument("--parts", type=int, default=8)
    s.add_argument("--spatial_weight", type=float, default=3.0)
    z = sub.add_parser("zju-cams")
    z.add_argument("--path", required=True)
    z.add_argument("--frames", type=int, default=300)
    m = sub.add_parser("smpl-prior")
    m.add_argument("--path", required=True)
    m.add_argument("--vertices", required=True)
    args = ap.parse_args(argv)
    {"thin": cmd_thin, "semseg": cmd_semseg, "zju-cams": cmd_zju_cams, "smpl-prior": cmd_smpl_prior}[
        args.cmd
    ](args)


if __name__ == "__main__":
    main()
