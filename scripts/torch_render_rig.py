#!/usr/bin/env python3
"""Stage-2 rendering and synthesis on the PyTorch port (the twin of
scripts/render_rig.py, with the same flags; ``--device`` in place of
``--platform``).

    python scripts/torch_render_rig.py --model_path out/ --synthetic                # test set, on the card
    python scripts/torch_render_rig.py --model_path out/ --mode time --device cpu

Modes: render (the test set's metrics, skinning-weight renders and a video:
an animated GIF and its PNG frames),
time (a time sweep at a fixed view), motion (random novel poses). Loads what
scripts/torch_run_pipeline.py (or scripts/run_pipeline.py) writes: cfg.json,
skeleton_tree.npz, rig/point_cloud/ and rig/checkpoints/. The scene is
read by the scene dispatch (``data/scene.py``), so every layout the pipeline
trains on renders; the reference reads a Blender / D-NeRF scene only, so
its scripts/run_zju.py fails at this step.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def save_video(path: Path, frames, fps: int = 30):
    """The frames as an animated GIF at ``path`` with the suffix .gif, and
    as PNGs in ``<stem>_frames/`` (PIL; the reference writes an mp4 through
    imageio where it has ffmpeg, which the card's installation lacks)."""
    import numpy as np
    from PIL import Image

    images = [Image.fromarray(np.clip(np.asarray(f) * 255, 0, 255).astype("uint8")) for f in frames]
    frame_dir = path.parent / (path.stem + "_frames")
    frame_dir.mkdir(parents=True, exist_ok=True)
    images[0].save(path.with_suffix(".gif"), save_all=True, append_images=images[1:], duration=1000.0 / fps, loop=0)
    for i, im in enumerate(images):
        im.save(frame_dir / f"{i:05d}.png")


def _checkpoint_frames(rig: Path) -> int:
    """The training frames of the latest checkpoint under ``rig``: the
    length of its projection losses (1 without a checkpoint)."""
    import numpy as np

    from riggs_tpu_torch.io.checkpoint import search_max_iteration

    it = search_max_iteration(rig / "checkpoints")
    if it is None:
        return 1
    with np.load(rig / "checkpoints" / f"iteration_{it}" / "state.npz") as ck:
        return ck[".proj_loss"].shape[0] if ".proj_loss" in ck.files else 1


def load_rig(model_path: Path, cfg, scene, device):
    """The stage-2 state of a pipeline's output: a template from the latest
    PLY, the skeleton tree and fresh nets, then the whole state from the
    latest rig checkpoint. Returns (state, its iteration), or (the template,
    None) with the reason printed when no checkpoint fits. With no
    ``scene``, the per-frame projection losses are sized from the
    checkpoint."""
    import torch

    from riggs_tpu_torch.io.checkpoint import load_checkpoint, load_skeleton_tree
    from riggs_tpu_torch.io.ply import load_gaussians_ply
    from riggs_tpu_torch.models import gaussians as G
    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.train import optim as O
    from riggs_tpu_torch.train.stage2 import Stage2State

    joints, parents, _, _ = load_skeleton_tree(model_path)
    gs = load_gaussians_ply(
        sorted((model_path / "rig" / "point_cloud").glob("iteration_*/point_cloud.ply"))[-1],
        capacity=cfg.model.capacity, max_sh_degree=cfg.model.sh_degree, isotropic=cfg.model.use_isotropic_gs,
        with_motion_mask=cfg.model.gs_with_motion_mask, device=device,
    )
    skel = SW.init_skeleton_warp(
        joints, parents, K=cfg.opt.skeleton_weight_knn, use_skinning_mlp=cfg.model.use_skinning_weight_mlp,
        use_template_offsets=cfg.model.use_template_offsets, n_control_nodes=cfg.model.skeleton_gs_sample_num,
        generator=torch.Generator(device=gs.device).manual_seed(0), device=gs.device,
    )
    n_train = len(scene.train_frames) if scene is not None else _checkpoint_frames(model_path / "rig")
    template = Stage2State(
        gs=gs, skel=skel, opt_gs=O.adam_init(gs.params_dict()), opt_skel=O.adam_init(skel.params_dict()),
        stats_gs=G.init_densify_stats(gs.capacity, device=gs.device),
        proj_loss=torch.ones(n_train, device=gs.device),
        it=torch.zeros((), dtype=torch.int32, device=gs.device),
    )
    try:
        state, it = load_checkpoint(model_path / "rig", template)
        print(f"loaded full checkpoint at iteration {it}")
        return state, it
    except (FileNotFoundError, ValueError, KeyError) as e:
        print(f"full-state checkpoint unavailable ({e}); using PLY + fresh nets")
        return template, None


def main(argv=None):
    import numpy as np

    from riggs_tpu_torch.data.scene import load_scene
    from riggs_tpu_torch.data.synthetic import make_scene_data
    from riggs_tpu_torch.eval.metrics import LpipsModel
    from riggs_tpu_torch.eval.synthesis import (format_numerical_res, generate_random_motion, interpolate_time,
                                                render_test_set)
    from riggs_tpu_torch.train.config import Config

    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--mode", choices=["render", "time", "motion"], default="render")
    ap.add_argument("--view_id", type=int, default=0)
    ap.add_argument("--n_frames", type=int, default=200)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--synthetic", action="store_true", help="rebuild the synthetic scene for cameras/gt")
    ap.add_argument("--lpips_backbone", default=None, help="torch backbone ckpt (see scripts/make_lpips_ckpt.py)")
    ap.add_argument("--lpips_heads", default=None, help="torch lpips linear-head ckpt")
    ap.add_argument("--lpips_net", choices=["alex", "vgg"], default="alex")
    args = ap.parse_args(argv)

    model_path = Path(args.model_path)
    cfg = Config.load(model_path / "cfg.json")
    if args.synthetic:
        _, scene = make_scene_data(n_train=16, n_test=4, width=128, height=128, device=args.device)
    else:
        scene = load_scene(cfg.model.source_path, white_background=cfg.model.white_background,
                           resolution=max(cfg.model.resolution, 1), device=args.device)
    state, _ = load_rig(model_path, cfg, scene, args.device)

    out_dir = model_path / "synthesis" / args.mode
    out_dir.mkdir(parents=True, exist_ok=True)
    lpips_model = None
    if args.lpips_backbone and args.lpips_heads:
        lpips_model = LpipsModel.from_torch_file(args.lpips_backbone, args.lpips_heads, net=args.lpips_net,
                                                 device=args.device)

    if args.mode == "render":
        rows, means, images = render_test_set(state.gs, state.skel, scene.test_frames,
                                              max_per_tile=cfg.pipe.max_per_tile, lpips_model=lpips_model)
        (out_dir / "numerical_res.txt").write_text(format_numerical_res(rows, means))
        save_video(out_dir / "video.mp4", images)
        print("means:", means)
    elif args.mode == "time":
        cam = scene.test_frames[args.view_id % len(scene.test_frames)].cam
        frames = interpolate_time(state.gs, state.skel, cam, n_frames=args.n_frames)
        save_video(out_dir / "video.mp4", frames)
        print(f"wrote {len(frames)} interpolated frames")
    else:
        cam = scene.test_frames[args.view_id % len(scene.test_frames)].cam
        frames, poses = generate_random_motion(state.gs, state.skel, cam)
        save_video(out_dir / "video.mp4", frames)
        np.savez(out_dir / "poses.npz", rotations=np.stack([p["local_rotation"] for p in poses]))
        print(f"wrote {len(frames)} random-motion frames")


if __name__ == "__main__":
    main()
