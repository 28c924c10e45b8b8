#!/usr/bin/env python3
"""Two-process multi-host smoke on the PyTorch port (the twin of
scripts/multihost_smoke.py): real cross-process collectives on one box.

Each process is one rank. It joins the group through
``parallel.multihost.init_distributed`` from the reference's launch
recipe (its flags become JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
JAX_PROCESS_ID; both processes on this box, so LOCAL_RANK and
LOCAL_WORLD_SIZE too), builds ``make_host_mesh``, loads only its own frames
(``host_local_frames`` + ``global_batch``) and runs one frame-parallel
static training step, or under ``--stage2`` the full stage-2 dp step, whose
gradient all-reduce crosses the processes. Then both save the new state
with the sharded checkpoint pair (the static run adds its batch's images as
a data-sharded leaf, one file a rank) and load it back, every leaf bitwise.

    python scripts/torch_multihost_smoke.py --process_id 0 &
    python scripts/torch_multihost_smoke.py --process_id 1

Process 0 prints ``MULTIHOST OK loss=<x> procs=2`` on success.
"""
import argparse
import dataclasses
import hashlib
import os
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _leaf_hash(tree) -> str:
    """A hash of a dict of tensors (a ``LocalRows`` leaf by its rows)."""
    from riggs_tpu_torch.parallel.mesh import LocalRows

    h = hashlib.sha256()
    for k in sorted(tree):
        v = tree[k].tree if isinstance(tree[k], LocalRows) else tree[k]
        h.update(k.encode())
        h.update(v.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv=None):
    import numpy as np
    import torch
    import torch.distributed as dist

    from riggs_tpu_torch.data.synthetic import make_scene_data
    from riggs_tpu_torch.device import resolve_device
    from riggs_tpu_torch.io.checkpoint import load_checkpoint_sharded, save_checkpoint_sharded, state_to_numpy
    from riggs_tpu_torch.models import gaussians as G
    from riggs_tpu_torch.parallel.multihost import global_batch, host_local_frames, init_distributed, make_host_mesh
    from riggs_tpu_torch.parallel.train import make_dp_static_step, make_dp_stage2_step, stack_frames
    from riggs_tpu_torch.train import optim as O
    from riggs_tpu_torch.train.static import TrainState
    from scripts.torch_scaling_bench import build_tiny_scene, dp_stage2_args

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="127.0.0.1:9911")
    ap.add_argument("--num_processes", type=int, default=2)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None,
                    help="the sharded checkpoint's directory (default: one under the temporary directory, "
                         "named by the coordinator's port, removed at the end)")
    ap.add_argument("--stage2", action="store_true",
                    help="run the full stage-2 dp step (warm-up, chamfer and template losses) instead of the static step")
    args = ap.parse_args(argv)
    os.environ.update(JAX_COORDINATOR_ADDRESS=args.coordinator, JAX_NUM_PROCESSES=str(args.num_processes),
                      JAX_PROCESS_ID=str(args.process_id), LOCAL_RANK=str(args.process_id),
                      LOCAL_WORLD_SIZE=str(args.num_processes))
    created = not dist.is_initialized()
    if not init_distributed(backend="gloo" if args.device == "cpu" else None):
        raise RuntimeError("the smoke needs two or more processes (--num_processes)")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(tile=1)
    n_data = mesh.shape["data"]
    out = Path(args.out or Path(tempfile.gettempdir()) / f"torch_multihost_smoke_{args.coordinator.rsplit(':', 1)[1]}")

    if args.stage2:
        scene, state = build_tiny_scene(width=32, height=32, n_train=n_data, device=dev)
        local, idx = host_local_frames(scene.train_frames, batch=n_data, step=0, mesh=mesh)
        batch = global_batch(stack_frames(local), mesh)
        before = state.skel.node_radius_log.detach().clone()
        step = make_dp_stage2_step(mesh, max_per_tile=128, use_chamfer=True)
        _, _, *rest = dp_stage2_args(state, [scene.train_frames[i] for i in idx], dev)
        new_state, metrics = step(state, batch, idx, *rest)
        loss = float(metrics["loss"])
        moved = float((new_state.skel.node_radius_log.detach() - before).abs().max())
        saved = new_state
        leaves = {k: torch.from_numpy(v) for k, v in state_to_numpy(new_state).items()}
    else:
        _, scene = make_scene_data(n_train=n_data, n_test=1, width=32, height=32, n_init_points=64, device=dev)
        gs = G.create_from_pcd(scene.init_points, scene.init_colors, capacity=128, max_sh_degree=0, device=dev)
        state = TrainState(gs=gs, opt=O.adam_init(gs.params_dict()), stats=G.init_densify_stats(128, device=dev))
        local, _ = host_local_frames(scene.train_frames, batch=n_data, step=0, mesh=mesh)
        batch = global_batch(stack_frames(local), mesh)
        step = make_dp_static_step(mesh, active_sh=0, max_per_tile=128)
        new_state, loss_t = step(state, batch, torch.zeros(3, device=dev), 1e-3)
        loss = float(loss_t)
        moved = float((new_state.gs.xyz - state.gs.xyz).abs().max())
        saved = dict(new_state.gs.params_dict(), images=dataclasses.replace(batch, tree=batch.tree.image))
        leaves = dict(saved)
    if not (np.isfinite(loss) and moved > 0.0):
        raise RuntimeError(f"the dp step: loss {loss}, moved {moved}")
    hashes = [None] * dist.get_world_size()
    dist.all_gather_object(hashes, _leaf_hash({k: v for k, v in leaves.items() if k != "images"}))
    if len(set(hashes)) != 1:
        raise RuntimeError("the ranks' states differ")

    save_checkpoint_sharded(out, 0, saved, mesh=mesh)
    back, it = load_checkpoint_sharded(out, saved, mesh=mesh)
    got = ({k: torch.from_numpy(v) for k, v in state_to_numpy(back).items()} if args.stage2 else back)
    if it != 0 or _leaf_hash(got) != _leaf_hash(leaves):
        raise RuntimeError("the sharded checkpoint did not load back bit for bit")
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(out, ignore_errors=True)
        print(f"MULTIHOST OK loss={loss:.6f} procs={dist.get_world_size()}", flush=True)
    if created:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
