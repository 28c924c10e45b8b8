#!/usr/bin/env python3
"""Stage-1 rendering and evaluation on the PyTorch port (the twin of
scripts/render_stage1.py, with the same flags; ``--device`` in place of
``--platform``).

    python scripts/torch_render_stage1.py --model_path out/ --synthetic       # test set, on the card
    python scripts/torch_render_stage1.py --model_path out/ --mode all --device cpu

Modes: render (the test set's metrics, a video, the nodes as an OBJ), time
(a fixed-view time sweep), all (the spiral pose and time sweep). Loads the
stage-1 checkpoint that scripts/torch_run_pipeline.py writes into the model
path.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def main(argv=None):
    import torch

    from riggs_tpu_torch.data.scene import load_scene
    from riggs_tpu_torch.data.synthetic import make_scene_data
    from riggs_tpu_torch.eval.render_stage1 import (interpolate_all_stage1, interpolate_time_stage1,
                                                    render_test_set_stage1)
    from riggs_tpu_torch.eval.synthesis import format_numerical_res
    from riggs_tpu_torch.io.checkpoint import load_checkpoint
    from riggs_tpu_torch.io.obj import write_skeleton_obj
    from riggs_tpu_torch.train.config import Config
    from riggs_tpu_torch.train.stage1 import init_stage1
    from torch_render_rig import save_video

    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--mode", choices=["render", "time", "all"], default="render")
    ap.add_argument("--view_id", type=int, default=0)
    ap.add_argument("--n_frames", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--synthetic", action="store_true")
    args = ap.parse_args(argv)

    model_path = Path(args.model_path)
    cfg = Config.load(model_path / "cfg.json")
    if args.synthetic:
        _, scene = make_scene_data(n_train=16, n_test=4, width=128, height=128, device=args.device)
    else:
        scene = load_scene(cfg.model.source_path, white_background=cfg.model.white_background,
                           resolution=max(cfg.model.resolution, 1), device=args.device)

    template = init_stage1(scene, cfg, generator=torch.Generator(device=args.device).manual_seed(0),
                           device=args.device)
    state, it = load_checkpoint(model_path, template)
    print(f"loaded stage-1 checkpoint at iteration {it}")

    out_dir = model_path / "synthesis_stage1" / args.mode
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.mode == "render":
        rows, means, images = render_test_set_stage1(state.gs, state.warp, scene.test_frames,
                                                     max_per_tile=cfg.pipe.max_per_tile)
        (out_dir / "numerical_res.txt").write_text(format_numerical_res(rows, means))
        save_video(out_dir / "video.mp4", images)
        write_skeleton_obj(out_dir / "nodes.obj", state.warp.nodes[:, :3].detach().cpu().numpy(),
                           [-1] * state.warp.node_num)
        print("means:", means)
    elif args.mode == "time":
        cam = scene.test_frames[args.view_id % len(scene.test_frames)].cam
        frames = interpolate_time_stage1(state.gs, state.warp, cam, n_frames=args.n_frames)
        save_video(out_dir / "video.mp4", frames)
        print(f"wrote {len(frames)} frames")
    else:
        frames = interpolate_all_stage1(state.gs, state.warp, width=scene.test_frames[0].cam.width,
                                        height=scene.test_frames[0].cam.height, n_frames=args.n_frames)
        save_video(out_dir / "video.mp4", frames)
        print(f"wrote {len(frames)} spiral frames")


if __name__ == "__main__":
    main()
