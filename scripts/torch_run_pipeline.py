#!/usr/bin/env python3
"""The full two-stage training pipeline on the PyTorch port (the twin of
scripts/run_pipeline.py, with the same flags; ``--device`` in place of
``--platform``).

    python scripts/torch_run_pipeline.py --source_path <d-nerf scene dir> --model_path out/
    python scripts/torch_run_pipeline.py --synthetic --model_path out/   # the built-in scene, on the card
    python scripts/torch_run_pipeline.py --synthetic --model_path out/ --device cpu
    python scripts/torch_run_pipeline.py --synthetic --model_path out/ --dp 2   # two ranks, started here
    torchrun --nproc_per_node 2 scripts/torch_run_pipeline.py --synthetic --model_path out/ --dp 2

Stage 1 (the node deformation) -> skeleton extraction -> stage 2 (the rigged
model), writing what scripts/run_pipeline.py writes: cfg.json, the stage-1
checkpoint and PLY, rig/ (the best-PSNR and final stage-2 checkpoints and
PLYs), skeleton_tree.npz, skeleton.obj, and numerical_res.txt from the test
set. Every config field is a flag (``--iterations 40`` and so on).

``--dp N`` trains frame-parallel: stage 1's phase B (``train_stage1_dp``)
and stage 2 (``train_stage2_dp``) over a mesh of N data rows, stage 2's
frames also split over ``--dp_tile`` ranks each (stage 1 has no tile axis:
the tile ranks of a data row repeat its frames). Under torchrun, or with the
environment ``parallel.multihost.init_distributed`` reads, this process is
one rank of the group; otherwise it starts the N x dp_tile ranks itself, on
this host (spawned processes on localhost, gloo when they share a card).
Only rank 0 writes files and prints.

``--viewer_port P`` serves the live training state with the web viewer
(``viz/web_viewer.py``) from a daemon thread: each
step hands it the step's Gaussians and a copy of the node warp (stage 1) or
skeleton (stage 2), whose parameters the next step overwrites in place.
``--gui_port P`` speaks the SIBR network_gui protocol on ``--gui_ip``,
polled after every step (``viz/sibr.py``; the canonical Gaussians, no
deformation, as the reference renders them, at the training window where
it holds the frame, else on the viewer's ladder: ``FrameHolder``). Both follow both of stage 1's
phases and stage 2; with ``--dp`` rank 0 alone serves. ``--detect_anomaly``
turns on ``torch.autograd.set_detect_anomaly`` in every rank, the
counterpart the reference names for its ``jax_debug_nans``.
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
    ap.add_argument("--viewer_port", type=int, default=0, help="serve a live training viewer")
    ap.add_argument("--gui_ip", type=str, default="127.0.0.1", help="SIBR remote-viewer host")
    ap.add_argument("--gui_port", type=int, default=0, help="speak the SIBR network_gui protocol on this port")
    ap.add_argument("--dp", type=int, default=0, help="frame-parallel training over this many data rows of ranks")
    ap.add_argument("--dp_tile", type=int, default=1, help="with --dp: split stage 2's frames over this many ranks each")
    ap.add_argument("--test_every", type=int, default=1000)
    ap.add_argument("--tensorboard", action="store_true")
    ap.add_argument("--resume", action="store_true", help="continue stage 2 from the latest checkpoint")
    ap.add_argument("--detect_anomaly", action="store_true",
                    help="torch.autograd.set_detect_anomaly: fail at the op whose backward makes the first NaN")
    add_config_args(ap)
    return ap.parse_args(argv)


def _rank_main(rank, world, port, argv):
    """One spawned rank: torchrun's environment, then the pipeline."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    main(argv)


def spawn_ranks(argv, world: int):
    """Run the pipeline on ``world`` spawned processes of this host, a
    group on a free localhost port; raises if a rank fails."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_rank_main, args=(world, port, list(argv)), nprocs=world, start_method="spawn")


def live_callbacks(args, cfg, model_path, dev):
    """The step callbacks of --viewer_port and --gui_port: (stage 1's, stage
    2's, a function that stops both servers), or Nones when neither is
    asked for. Stage 1's takes the reference's (state, it) and the port's
    (state, it, phase)."""
    import copy

    import torch

    if not (args.viewer_port or args.gui_port):
        return None, None, lambda: None
    from riggs_tpu_torch.viz.sibr import SibrServer
    from riggs_tpu_torch.viz.web_viewer import FrameHolder, ViewerServer

    live = {"gs": None, "skel": None, "warp": None}
    viewer = sibr = None
    if args.viewer_port:
        viewer = ViewerServer(state_fn=lambda: (live["gs"], live["skel"], live["warp"]), device=dev)
        viewer.serve(port=args.viewer_port, blocking=False)
    if args.gui_port:
        sibr = SibrServer(args.gui_ip, args.gui_port, verify=str(cfg.model.source_path or model_path), device=dev)
        print(f"SIBR network_gui listening on {args.gui_ip}:{sibr.port}", flush=True)

    sibr_frames = FrameHolder(cfg.pipe.max_per_tile)  # the training window where it holds the frame

    @torch.no_grad()
    def sibr_render(cam, scaling_modifier):
        gs = live["gs"]
        return sibr_frames(cam, gs, torch.zeros(3, device=gs.device), scaling_modifier=scaling_modifier,
                           active_sh_degree=gs.max_sh_degree)

    def hand_over(gs, skel, warp):
        snap = dict(gs=gs, skel=skel, warp=warp)
        if viewer is not None:
            # copies: the next step writes the nets' parameters in place while
            # the viewer's thread may be rendering; swapped in under its lock,
            # so no frame mixes two states
            snap.update(skel=copy.deepcopy(skel), warp=copy.deepcopy(warp))
            with viewer._lock:
                live.update(snap)
        else:
            live.update(snap)
        if sibr is not None:
            sibr.poll(sibr_render)

    def close():
        if viewer is not None:
            viewer.shutdown()
        if sibr is not None:
            sibr.close()

    return (lambda state, it, phase=None: hand_over(state.gs, None, state.warp),
            lambda state, it: hand_over(state.gs, state.skel, None), close)


def main(argv=None):
    import torch
    import torch.distributed as dist

    from riggs_tpu_torch.data.scene import load_scene
    from riggs_tpu_torch.data.synthetic import make_scene_data
    from riggs_tpu_torch.eval.synthesis import format_numerical_res, render_test_set
    from riggs_tpu_torch.io.checkpoint import save_checkpoint, save_skeleton_tree
    from riggs_tpu_torch.io.obj import write_skeleton_obj
    from riggs_tpu_torch.parallel.mesh import make_mesh
    from riggs_tpu_torch.parallel.multihost import init_distributed
    from riggs_tpu_torch.parallel.stage1_dp import train_stage1_dp
    from riggs_tpu_torch.parallel.stage2_dp import train_stage2_dp
    from riggs_tpu_torch.train.config import config_from_args
    from riggs_tpu_torch.train.logging import TrainLogger
    from riggs_tpu_torch.train.stage1 import train_stage1
    from riggs_tpu_torch.train.stage2 import train_stage2

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    mesh = None
    if args.dp > 1:
        if not init_distributed():
            spawn_ranks(argv, args.dp * args.dp_tile)
            return
        mesh = make_mesh(data=args.dp, tile=args.dp_tile)
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    dev = args.device
    if mesh is not None and dev.startswith("cuda"):
        dev = f"cuda:{torch.cuda.current_device()}"
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    cfg = config_from_args(args)
    model_path = Path(cfg.model.model_path or "output/run")
    if lead:
        model_path.mkdir(parents=True, exist_ok=True)
        cfg.save(model_path / "cfg.json")
    s1_cb, s2_cb, close = live_callbacks(args, cfg, model_path, dev) if lead else (None, None, lambda: None)

    if args.synthetic:
        _, scene = make_scene_data(
            n_train=args.synthetic_frames, n_test=max(args.synthetic_frames // 4, 1),
            width=args.synthetic_size, height=args.synthetic_size, figure=args.synthetic_figure,
            points_per_seg=args.synthetic_points, n_init_points=args.synthetic_init_points, device=dev,
        )
    else:
        scene = load_scene(cfg.model.source_path, white_background=cfg.model.white_background,
                           resolution=max(cfg.model.resolution, 1), device=dev)
    say(f"scene: {len(scene.train_frames)} train / {len(scene.test_frames)} test frames")

    t0 = time.time()
    source_path = None if args.synthetic else cfg.model.source_path
    if mesh is not None:
        s1, _ = train_stage1_dp(scene, cfg, mesh, log_every=500, step_callback=s1_cb, source_path=source_path,
                                device=dev)
    else:
        s1, _ = train_stage1(scene, cfg, log_every=500, step_callback=s1_cb, source_path=source_path, device=dev)
    say(f"stage 1 done in {time.time() - t0:.0f}s")
    if lead:
        save_checkpoint(model_path, cfg.opt.iterations, s1, gs=s1.gs, cfg=cfg)

    if args.stage in ("2", "both"):
        t0 = time.time()
        logger = TrainLogger(model_path / "tb") if args.tensorboard and lead else None
        if mesh is not None:
            s2, info, _ = train_stage2_dp(s1, scene, cfg, mesh, log_every=500, step_callback=s2_cb,
                                          test_every=args.test_every, model_path=model_path / "rig", device=dev)
        else:
            s2, info, _ = train_stage2(s1, scene, cfg, log_every=500, step_callback=s2_cb, test_every=args.test_every,
                                       model_path=model_path / "rig", logger=logger, resume=args.resume, device=dev)
        if logger is not None:
            logger.close()
        say(f"stage 2 done in {time.time() - t0:.0f}s")
        if lead:
            save_skeleton_tree(model_path, info.joints, info.parents, info.joint_node_indices, info.template_idx)
            write_skeleton_obj(model_path / "skeleton.obj", info.joints, info.parents)
            save_checkpoint(model_path / "rig", cfg.opt.iterations, s2, gs=s2.gs, cfg=cfg)
            if scene.test_frames:
                rows, means, _ = render_test_set(s2.gs, s2.skel, scene.test_frames,
                                                 max_per_tile=cfg.pipe.max_per_tile)
                (model_path / "numerical_res.txt").write_text(format_numerical_res(rows, means))
                print("test metrics:", means)
    close()
    if mesh is not None:
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
