#!/usr/bin/env python3
"""The pipeline over the ZJU-MoCap subjects on the PyTorch port (the twin of
scripts/run_zju.py, with the same flags, and ``--device`` passed to both
scripts it runs).

    python scripts/torch_run_zju.py --data_root <dir of subject dirs> --out_root output/zju
    python scripts/torch_run_zju.py --data_root data --subjects 377 --device cpu --extra --iterations 40

For each subject directory present under ``--data_root`` (HumanNeRF layout:
train/cameras.pkl, mesh_infos.pkl, images/, masks/, SMPL_prior/,
points3d.ply, test/view_XX/), scripts/torch_run_pipeline.py with stage 1
supervised by the SMPL reference points (512 nodes, skeleton_warm_up 5000,
the skinning MLP and template offsets on), then scripts/torch_render_rig.py
--mode render on its output; ``--extra`` flags go to the pipeline.
"""
import argparse
import subprocess
import sys
from pathlib import Path

SUBJECTS = ["377", "386", "387", "392", "393", "394"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--out_root", default="output/zju")
    ap.add_argument("--subjects", nargs="*", default=SUBJECTS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[])
    args = ap.parse_args(argv)

    here = Path(__file__).resolve().parent
    for sub in args.subjects:
        src = Path(args.data_root) / sub
        out = Path(args.out_root) / sub
        if not src.exists():
            print(f"skip {sub}: {src} not found")
            continue
        cmd = [sys.executable, str(here / "torch_run_pipeline.py"),
               "--source_path", str(src), "--model_path", str(out),
               "--node_num", "512", "--skeleton_warm_up", "5000",
               "--use_skinning_weight_mlp", "--use_template_offsets",
               "--gt_alpha_mask_as_scene_mask", "--device", args.device] + args.extra
        print(">>>", sub, flush=True)
        subprocess.run(cmd, check=True)
        subprocess.run([sys.executable, str(here / "torch_render_rig.py"), "--model_path", str(out), "--mode", "render",
                        "--device", args.device], check=True)


if __name__ == "__main__":
    main()
