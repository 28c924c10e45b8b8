#!/usr/bin/env python3
"""Frame-parallel scaling harness on the PyTorch port (the twin of
scripts/scaling_bench.py): the dp stage-2 step's time against the mesh size.

For data = 1, 2, 4, ... up to the number of ranks, one job of that many
ranks (spawned processes of this host, one group each) times the real
frame-parallel stage-2 step (``make_dp_stage2_step``, the full loss set) on
a tiny synthetic scene, one frame a rank: fixed work a rank, so the ideal is
a flat time. Rank 0 reports; this process prints the reference's line

    data= n:   ms ms/step   frames/s frames/s  scaling-eff  eff%

The ranks: one a card by default (NCCL), ``--ranks N`` ranks sharing the
cards (gloo where they share one), or ``--cpu N`` gloo ranks on the CPU,
which share one host's cores: their efficiency checks the harness and the
collectives, not the scaling of devices.

    python scripts/torch_scaling_bench.py              # the cards
    python scripts/torch_scaling_bench.py --cpu 2 --iters 1
"""
import argparse
import json
import os
import socket
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def build_tiny_scene(width=64, height=64, n_train=4, render_gt=True, device=None):
    """A small stage-2 problem: make_scene_data's chain at ``width`` x
    ``height`` (``n_train`` frames, one test frame, 150 initial points), its
    cloud as 256 Gaussian slots at SH degree 1 without a motion mask, and a
    seeded three-joint skeleton with the skinning MLP and template offsets;
    returns (scene, Stage2State)."""
    import numpy as np
    import torch

    from riggs_tpu_torch.data.synthetic import make_scene_data
    from riggs_tpu_torch.device import resolve_device
    from riggs_tpu_torch.models import gaussians as G
    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.train import optim as O
    from riggs_tpu_torch.train.stage2 import Stage2State

    dev = resolve_device(device)
    _, scene = make_scene_data(n_train=n_train, n_test=1, width=width, height=height, max_thinned=64,
                               n_init_points=150, render_gt=render_gt, device=dev)
    gs = G.create_from_pcd(scene.init_points, scene.init_colors, capacity=256, max_sh_degree=1,
                           with_motion_mask=False, device=dev)
    joints = np.array([[0.0, -0.6, 0.0], [0.0, 0.0, 0.0], [0.0, 0.6, 0.0]], np.float32)
    skel = SW.init_skeleton_warp(joints, (0, 0, 1), K=-1, use_skinning_mlp=True, use_template_offsets=True,
                                 generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    state = Stage2State(gs=gs, skel=skel, opt_gs=O.adam_init(gs.params_dict()), opt_skel=O.adam_init(skel.params_dict()),
                        stats_gs=G.init_densify_stats(gs.capacity, device=dev),
                        proj_loss=torch.full((n_train,), 1e5, device=dev),
                        it=torch.zeros((), dtype=torch.int32, device=dev))
    return scene, state


def dp_stage2_args(state, frames, device):
    """A dp stage-2 step's arguments after the state for a batch of
    ``frames``, one a data row: uids 0..B-1, zero stage-1 deformations, the
    template-offset weight 1e-2, SH degree 1, everything unlocked."""
    import numpy as np
    import torch

    from riggs_tpu_torch.parallel.train import stack_frames, stage2_flags

    B, J = len(frames), state.skel.joints.shape[0]
    lrs_gs = {k: 1e-4 for k in state.gs.params_dict()}
    return (stack_frames(frames), np.arange(B), torch.zeros(3, device=device), lrs_gs, 1e-4,
            torch.zeros((B, state.gs.capacity, 3), device=device), torch.zeros((B, J, 3), device=device),
            np.full(B, 1e-2, np.float32), np.zeros(B, np.float32), stage2_flags(active_sh=1))


def _bench_rank(rank, world, port, args, out):
    """One rank of a job: torchrun's environment, the group, ``iters``
    timed steps after a warm one; rank 0 writes its ms a step."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    from riggs_tpu_torch.parallel.multihost import init_distributed, make_host_mesh, pick_backend
    from riggs_tpu_torch.parallel.train import make_dp_stage2_step

    if args.cpu and "OMP_NUM_THREADS" not in os.environ:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    backend = "gloo" if args.cpu else pick_backend(world)
    if not init_distributed(backend):  # one rank: a group of one, so the step's collectives run
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        dev = torch.device("cpu") if args.cpu else torch.device("cuda", torch.cuda.current_device())
        mesh = make_host_mesh(tile=1)
        scene, state = build_tiny_scene(width=args.width, height=args.width, n_train=args.max_data, device=dev)
        step = make_dp_stage2_step(mesh, max_per_tile=128, use_chamfer=True)
        a = dp_stage2_args(state, scene.train_frames[:world], dev)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        state, m = step(state, *a)
        float(m["loss"])
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            state, m = step(state, *a)
        loss = float(m["loss"])
        sync()
        dt = (time.perf_counter() - t0) / args.iters
        if rank == 0:
            Path(out).write_text(json.dumps({"s_per_step": dt, "loss": loss, "backend": mesh.backend}))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    import torch
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0, help="this many gloo ranks on the CPU")
    ap.add_argument("--ranks", type=int, default=0, help="this many ranks on the cards (default: one a card)")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if args.cpu:
        print("NOTE: CPU ranks share one host's cores: efficiency numbers check the harness and the "
              "collectives, NOT the scaling of devices (real cards add compute per rank; these do not).")
        total = args.cpu
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --cpu N to run N ranks on the CPU")
        total = args.ranks or torch.cuda.device_count()
    sizes = [n for n in (1, 2, 4, 8, 16) if n <= total]
    args.max_data = max(sizes)
    base = None
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for n in sizes:
            out = Path(tmp) / f"data{n}.json"
            mp.start_processes(_bench_rank, args=(n, _free_port(), args, str(out)), nprocs=n, start_method="spawn")
            r = json.loads(out.read_text())
            dt = r["s_per_step"]
            fps = n / dt
            base = fps if base is None else base
            eff = fps / (base * n)
            print(f"data={n:2d}: {dt * 1e3:8.1f} ms/step  {fps:7.2f} frames/s  scaling-eff {eff * 100:5.1f}%",
                  flush=True)
            rows.append(dict(data=n, ms_per_step=dt * 1e3, frames_per_s=fps, efficiency=eff, loss=r["loss"],
                             backend=r["backend"]))
    return rows


if __name__ == "__main__":
    main()
