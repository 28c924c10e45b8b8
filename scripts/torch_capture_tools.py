#!/usr/bin/env python3
"""Capture tooling on the PyTorch port's host code: video -> frames, a COLMAP
model -> NeRF transforms (the twin of scripts/capture_tools.py, with the
same subcommands and flags).

    python scripts/torch_capture_tools.py frames --video clip.mp4 --out scene/images [--every 2]
    python scripts/torch_capture_tools.py colmap2nerf --path scene [--images_dir images]
    python scripts/torch_capture_tools.py masks --path scene [--bg_color 1,1,1 --threshold 0.15]

  frames      every ``--every``-th frame of a video as frame_00000.png, ...,
              decoded by OpenCV (the card's installation has no imageio,
              which the reference uses); the same pixels
  colmap2nerf a COLMAP sparse model (binary or text) -> transforms_train.json
              in the instant-ngp convention that the Blender reader takes
  masks       chroma-threshold foreground masks, a fallback for a real
              segmenter
Host numpy, PIL and OpenCV only: nothing here runs on the card.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def cmd_frames(args):
    import cv2

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cap = cv2.VideoCapture(str(args.video))
    if not cap.isOpened():
        raise FileNotFoundError(f"OpenCV cannot open {args.video}")
    count = i = 0
    while True:
        ok, frame = cap.read()  # BGR, written back as BGR: the file holds the video's RGB
        if not ok:
            break
        if i % args.every == 0:
            cv2.imwrite(str(out / f"frame_{count:05d}.png"), frame)
            count += 1
        i += 1
    cap.release()
    print(f"wrote {count} frames")


def cmd_colmap2nerf(args):
    from riggs_tpu_torch.data.colmap import (qvec2rotmat, read_cameras_binary, read_cameras_text,
                                             read_images_binary, read_images_text)

    src = Path(args.path)
    sparse = src / "sparse" / "0"
    if not sparse.exists():
        sparse = src / "sparse"
    if (sparse / "cameras.bin").exists():
        cams = read_cameras_binary(sparse / "cameras.bin")
        images = read_images_binary(sparse / "images.bin")
    else:
        cams = read_cameras_text(sparse / "cameras.txt")
        images = read_images_text(sparse / "images.txt")

    cam0 = next(iter(cams.values()))
    p = cam0["params"]
    fx = p[0]
    w, h = cam0["width"], cam0["height"]
    angle_x = 2 * np.arctan(w / (2 * fx))

    frames = []
    metas = sorted(images.values(), key=lambda m: m["name"])
    for i, m in enumerate(metas):
        R = qvec2rotmat(m["qvec"])
        t = m["tvec"]
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = t
        c2w = np.linalg.inv(w2c)
        # COLMAP -> NeRF axis convention (colmap2nerf.py): flip y and z
        c2w[0:3, 1] *= -1
        c2w[0:3, 2] *= -1
        frames.append(
            {
                "file_path": f"{args.images_dir}/{m['name']}",
                "time": i / max(len(metas) - 1, 1),
                "transform_matrix": c2w.tolist(),
            }
        )
    meta = {"camera_angle_x": float(angle_x), "frames": frames}
    (src / "transforms_train.json").write_text(json.dumps(meta, indent=2))
    print(f"wrote transforms_train.json with {len(frames)} frames")


def cmd_masks(args):
    from PIL import Image

    src = Path(args.path)
    out = src / "masks"
    out.mkdir(exist_ok=True)
    for p in sorted((src / args.images_dir).glob("*.png")):
        im = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
        bgc = np.asarray([float(x) for x in args.bg_color.split(",")])
        mask = (np.abs(im - bgc).sum(-1) > args.threshold).astype(np.uint8) * 255
        Image.fromarray(mask).save(out / p.name)
    print("wrote masks (chroma-threshold fallback — use a real segmenter for production)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("frames")
    f.add_argument("--video", required=True)
    f.add_argument("--out", required=True)
    f.add_argument("--every", type=int, default=1)
    c = sub.add_parser("colmap2nerf")
    c.add_argument("--path", required=True)
    c.add_argument("--images_dir", default="images")
    m = sub.add_parser("masks")
    m.add_argument("--path", required=True)
    m.add_argument("--images_dir", default="images")
    m.add_argument("--bg_color", default="1,1,1")
    m.add_argument("--threshold", type=float, default=0.15)
    args = ap.parse_args(argv)
    {"frames": cmd_frames, "colmap2nerf": cmd_colmap2nerf, "masks": cmd_masks}[args.cmd](args)


if __name__ == "__main__":
    main()
