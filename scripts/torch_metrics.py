#!/usr/bin/env python3
"""Image metrics of rendered folders on the PyTorch port (the twin of
scripts/metrics.py, with the same flags; ``--device`` in place of
``--platform``).

    python scripts/torch_metrics.py -m out/ [--lpips_backbone b.pth --lpips_heads h.pth]

Walks <model_path>/test/ours_N/ (or <model_path> itself) for renders/ and
gt/ image pairs of the same name, and writes the mean PSNR / SSIM / MS-SSIM
(and LPIPS with weights) per folder to results.json, each view's to
per_view.json.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    import numpy as np
    import torch
    from PIL import Image

    from riggs_tpu_torch.device import resolve_device
    from riggs_tpu_torch.eval.metrics import LpipsModel, evaluate_image

    ap = argparse.ArgumentParser()
    ap.add_argument("--model_paths", "-m", nargs="+", required=True)
    ap.add_argument("--renders_dir", default="renders")
    ap.add_argument("--gt_dir", default="gt")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lpips_backbone", default=None, help="torch backbone ckpt for LPIPS")
    ap.add_argument("--lpips_heads", default=None, help="torch lpips linear-head ckpt")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    lpips_model = None
    if args.lpips_backbone and args.lpips_heads:
        lpips_model = LpipsModel.from_torch_file(args.lpips_backbone, args.lpips_heads, device=dev)

    def load(path):
        return torch.from_numpy(np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0).to(dev)

    for model_path in args.model_paths:
        base = Path(model_path)
        results, per_view = {}, {}
        for scene_dir in list(base.glob("test/ours_*")) or [base]:
            rdir, gdir = scene_dir / args.renders_dir, scene_dir / args.gt_dir
            if not rdir.exists() or not gdir.exists():
                continue
            rows = {r.name: evaluate_image(load(r), load(gdir / r.name), lpips_model)
                    for r in sorted(rdir.iterdir()) if (gdir / r.name).exists()}
            if rows:
                keys = next(iter(rows.values())).keys()
                results[scene_dir.name] = {k: float(np.mean([r[k] for r in rows.values()])) for k in keys}
                per_view[scene_dir.name] = rows
        (base / "results.json").write_text(json.dumps(results, indent=2))
        (base / "per_view.json").write_text(json.dumps(per_view, indent=2))
        print(model_path, json.dumps(results))


if __name__ == "__main__":
    main()
