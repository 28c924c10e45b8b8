#!/usr/bin/env python3
"""The batch over the 11 D-NeRF / DG-Mesh synthetic scenes on the PyTorch
port (the twin of scripts/run_synthesis.py, with the same flags and
``--device``).

    python scripts/torch_run_synthesis.py --data_root data/ [--out_root output/synthesis] [--scenes trex mutant]
    python scripts/torch_run_synthesis.py --data_root data/ --extra --iterations 2000

For each scene found under ``--data_root``: scripts/torch_run_pipeline.py
at the paper's settings (512 nodes, isotropic Gaussians with the motion
mask, the skinning MLP and template offsets, then ``--extra``), then
scripts/torch_render_rig.py in its render, time and motion modes at the
scene's fixed view, each a process of its own; a missing scene is skipped.
"""
import argparse
import subprocess
import sys
from pathlib import Path

SCENES = [
    "jumpingjacks", "mutant", "hook", "hellwarrior", "standup", "trex",
    "beagle", "bird", "duck", "girlwalk", "horse",
]
# the fixed interpolation view of each scene
VIEW_IDS = {"jumpingjacks": 1, "mutant": 0, "hook": 2, "hellwarrior": 0, "standup": 0,
            "trex": 1, "beagle": 0, "bird": 0, "duck": 0, "girlwalk": 0, "horse": 0}


def commands(scene: str, src: Path, out: Path, device: str, extra: list) -> list[list[str]]:
    """The pipeline's command, then the three renders', for one scene."""
    here = Path(__file__).resolve().parent
    pipe = [sys.executable, str(here / "torch_run_pipeline.py"), "--source_path", str(src), "--model_path", str(out),
            "--device", device, "--node_num", "512", "--use_isotropic_gs", "--gs_with_motion_mask",
            "--use_skinning_weight_mlp", "--use_template_offsets"] + list(extra)
    renders = [[sys.executable, str(here / "torch_render_rig.py"), "--model_path", str(out), "--mode", mode,
                "--view_id", str(VIEW_IDS.get(scene, 0)), "--device", device] for mode in ("render", "time", "motion")]
    return [pipe] + renders


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--out_root", default="output/synthesis")
    ap.add_argument("--scenes", nargs="*", default=SCENES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[])
    args = ap.parse_args(argv)

    for scene in args.scenes:
        src = Path(args.data_root) / scene
        out = Path(args.out_root) / scene
        if not src.exists():
            print(f"skip {scene}: {src} not found")
            continue
        print(">>>", scene, flush=True)
        for cmd in commands(scene, src, out, args.device, args.extra):
            subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
