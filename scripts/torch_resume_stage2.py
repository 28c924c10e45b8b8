#!/usr/bin/env python3
"""Resume the two-stage pipeline at stage 2 from a saved stage-1 checkpoint,
on the PyTorch port (the twin of scripts/resume_stage2.py, with the same
flags and ``--device``).

    python scripts/torch_resume_stage2.py --model_path out/ --synthetic_size 128 --synthetic_frames 16 \\
        --synthetic_figure chain --synthetic_points 120 --synthetic_init_points 300 --device cpu

Rebuilds the synthetic scene the pipeline trained on (the flags must be the
pipeline's), reads the whole stage-1 state from the model path's latest
``checkpoints/iteration_N/state.npz`` (either package's file) and runs
stage 2 with cfg.json's settings (``--iterations`` overrides its length),
resuming from any stage-2 checkpoint under rig/; then writes what the
pipeline writes after stage 2: rig/'s final checkpoint and PLY,
skeleton_tree.npz, skeleton.obj and numerical_res.txt. The template's node
set is sized from the file: the reference's retry with ``finalize_nodes``
changes no shape, so a checkpoint whose nodes were densified or pruned
loads only here.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def stage1_template(scene, cfg, model_path: Path, device):
    """``init_stage1``'s state with as many warp nodes as the latest stage-1
    checkpoint holds (the nodes themselves are read from it)."""
    from riggs_tpu_torch.io import checkpoint as C

    it = C.search_max_iteration(model_path / "checkpoints")
    if it is None:
        raise FileNotFoundError(f"no stage-1 checkpoint under {model_path / 'checkpoints'}")
    return C.stage1_template(scene, cfg, model_path / "checkpoints" / f"iteration_{it}" / "state.npz", device)


def main(argv=None):
    from riggs_tpu_torch.data.synthetic import make_scene_data
    from riggs_tpu_torch.eval.synthesis import format_numerical_res, render_test_set
    from riggs_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint, save_skeleton_tree
    from riggs_tpu_torch.io.obj import write_skeleton_obj
    from riggs_tpu_torch.train.config import Config
    from riggs_tpu_torch.train.stage2 import train_stage2

    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--iterations", type=int, default=None, help="override stage-2 iterations")
    ap.add_argument("--test_every", type=int, default=4000)
    ap.add_argument("--synthetic_size", type=int, default=800)
    ap.add_argument("--synthetic_frames", type=int, default=64)
    ap.add_argument("--synthetic_figure", default="biped")
    ap.add_argument("--synthetic_points", type=int, default=250)
    ap.add_argument("--synthetic_init_points", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model_path = Path(args.model_path)
    cfg = Config.load(model_path / "cfg.json")
    if args.iterations is not None:
        cfg.opt.iterations = args.iterations
    _, scene = make_scene_data(
        n_train=args.synthetic_frames, n_test=max(args.synthetic_frames // 4, 1), width=args.synthetic_size,
        height=args.synthetic_size, figure=args.synthetic_figure, points_per_seg=args.synthetic_points,
        n_init_points=args.synthetic_init_points, device=args.device,
    )
    print(f"scene: {len(scene.train_frames)} train / {len(scene.test_frames)} test", flush=True)
    s1, it = load_checkpoint(model_path, stage1_template(scene, cfg, model_path, args.device))
    print(f"restored stage-1 state from iteration {it}", flush=True)

    t0 = time.time()
    s2, info, _ = train_stage2(s1, scene, cfg, log_every=500, test_every=args.test_every, model_path=model_path / "rig",
                               resume=True, device=args.device)
    print(f"stage 2 done in {time.time() - t0:.0f}s", flush=True)
    save_skeleton_tree(model_path, info.joints, info.parents, info.joint_node_indices, info.template_idx)
    write_skeleton_obj(model_path / "skeleton.obj", info.joints, info.parents)
    save_checkpoint(model_path / "rig", cfg.opt.iterations, s2, gs=s2.gs, cfg=cfg)
    if scene.test_frames:
        rows, means, _ = render_test_set(s2.gs, s2.skel, scene.test_frames, max_per_tile=cfg.pipe.max_per_tile)
        print("FINAL test:", " ".join(f"{k}={v:.4f}" for k, v in means.items()), flush=True)
        (model_path / "numerical_res.txt").write_text(format_numerical_res(rows, means))


if __name__ == "__main__":
    main()
