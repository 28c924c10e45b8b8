#!/usr/bin/env python3
"""The full two-stage training pipeline on the PyTorch port (the twin of
scripts/run_pipeline.py, with the same flags; ``--device`` in place of
``--platform``).

    python scripts/torch_run_pipeline.py --source_path <d-nerf scene dir> --model_path out/
    python scripts/torch_run_pipeline.py --synthetic --model_path out/   # the built-in scene, on the card
    python scripts/torch_run_pipeline.py --synthetic --model_path out/ --device cpu

Stage 1 (the node deformation) -> skeleton extraction -> stage 2 (the rigged
model), writing what scripts/run_pipeline.py writes: cfg.json, the stage-1
checkpoint and PLY, rig/ (the best-PSNR and final stage-2 checkpoints and
PLYs), skeleton_tree.npz, skeleton.obj, and numerical_res.txt from the test
set. Every config field is a flag (``--iterations 40`` and so on). The
multi-device, viewer and debugging flags raise where the reference would use
them: their ports are later work (ROADMAP A10, A11).
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_args(argv=None):
    from riggs_tpu_torch.train.config import add_config_args

    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", action="store_true", help="use the built-in synthetic scene")
    ap.add_argument("--synthetic_size", type=int, default=128)
    ap.add_argument("--synthetic_frames", type=int, default=16)
    ap.add_argument("--synthetic_figure", choices=["chain", "biped"], default="chain")
    ap.add_argument("--synthetic_points", type=int, default=120, help="blob points per segment")
    ap.add_argument("--synthetic_init_points", type=int, default=300, help="random init cloud size")
    ap.add_argument("--stage", choices=["1", "2", "both"], default="both")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--viewer_port", type=int, default=0, help="serve a live training viewer (ROADMAP A10)")
    ap.add_argument("--gui_ip", type=str, default="127.0.0.1", help="SIBR remote-viewer host")
    ap.add_argument("--gui_port", type=int, default=0, help="the SIBR network_gui protocol (ROADMAP A10)")
    ap.add_argument("--dp", type=int, default=0, help="frame-parallel training over this many devices (ROADMAP A11)")
    ap.add_argument("--dp_tile", type=int, default=1, help="with --dp: tile parallelism (ROADMAP A11)")
    ap.add_argument("--test_every", type=int, default=1000)
    ap.add_argument("--tensorboard", action="store_true")
    ap.add_argument("--resume", action="store_true", help="continue stage 2 from the latest checkpoint")
    ap.add_argument("--detect_anomaly", action="store_true", help="fail at the first NaN (ROADMAP A10)")
    add_config_args(ap)
    args = ap.parse_args(argv)
    if args.dp > 1:
        raise NotImplementedError("--dp: stage 2's frame-parallel loop is ported (riggs_tpu_torch.parallel.stage2_dp), "
                                  "stage 1's (train_stage1_dp) comes with the rest of ROADMAP A11")
    if args.viewer_port or args.gui_port:
        raise NotImplementedError("--viewer_port / --gui_port: the viewers come with ROADMAP A10")
    if args.detect_anomaly:
        raise NotImplementedError("--detect_anomaly comes with the debugging and viewing tools (ROADMAP A10)")
    return args


def main(argv=None):
    from riggs_tpu_torch.data.scene import load_scene
    from riggs_tpu_torch.data.synthetic import make_scene_data
    from riggs_tpu_torch.eval.synthesis import format_numerical_res, render_test_set
    from riggs_tpu_torch.io.checkpoint import save_checkpoint, save_skeleton_tree
    from riggs_tpu_torch.io.obj import write_skeleton_obj
    from riggs_tpu_torch.train.config import config_from_args
    from riggs_tpu_torch.train.logging import TrainLogger
    from riggs_tpu_torch.train.stage1 import train_stage1
    from riggs_tpu_torch.train.stage2 import train_stage2

    args = parse_args(argv)
    dev = args.device
    cfg = config_from_args(args)
    model_path = Path(cfg.model.model_path or "output/run")
    model_path.mkdir(parents=True, exist_ok=True)
    cfg.save(model_path / "cfg.json")

    if args.synthetic:
        _, scene = make_scene_data(
            n_train=args.synthetic_frames, n_test=max(args.synthetic_frames // 4, 1),
            width=args.synthetic_size, height=args.synthetic_size, figure=args.synthetic_figure,
            points_per_seg=args.synthetic_points, n_init_points=args.synthetic_init_points, device=dev,
        )
    else:
        scene = load_scene(cfg.model.source_path, white_background=cfg.model.white_background,
                           resolution=max(cfg.model.resolution, 1), device=dev)
    print(f"scene: {len(scene.train_frames)} train / {len(scene.test_frames)} test frames")

    t0 = time.time()
    s1, _ = train_stage1(scene, cfg, log_every=500, source_path=None if args.synthetic else cfg.model.source_path,
                         device=dev)
    print(f"stage 1 done in {time.time() - t0:.0f}s")
    save_checkpoint(model_path, cfg.opt.iterations, s1, gs=s1.gs, cfg=cfg)

    if args.stage in ("2", "both"):
        t0 = time.time()
        logger = TrainLogger(model_path / "tb") if args.tensorboard else None
        s2, info, _ = train_stage2(s1, scene, cfg, log_every=500, test_every=args.test_every,
                                   model_path=model_path / "rig", logger=logger, resume=args.resume, device=dev)
        if logger is not None:
            logger.close()
        print(f"stage 2 done in {time.time() - t0:.0f}s")
        save_skeleton_tree(model_path, info.joints, info.parents, info.joint_node_indices, info.template_idx)
        write_skeleton_obj(model_path / "skeleton.obj", info.joints, info.parents)
        save_checkpoint(model_path / "rig", cfg.opt.iterations, s2, gs=s2.gs, cfg=cfg)
        if scene.test_frames:
            rows, means, _ = render_test_set(s2.gs, s2.skel, scene.test_frames, max_per_tile=cfg.pipe.max_per_tile)
            (model_path / "numerical_res.txt").write_text(format_numerical_res(rows, means))
            print("test metrics:", means)


if __name__ == "__main__":
    main()
