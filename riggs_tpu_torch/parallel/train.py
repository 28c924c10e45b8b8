"""The frame-parallel stage-2 training step over a data x tile mesh.

Port of ``riggs_tpu/parallel/train.py:29-192`` (``stack_frames``,
``stage2_flags``, ``make_dp_stage2_step``). The reference's step vmaps the
per-frame loss over a batch of B frames sharded over the mesh's ``data``
axis and takes the mean, and XLA turns the mean's gradient into a sum over
the devices. Here each rank of a data group takes its rows of the batch
(``mesh.shard_batch``), renders and differentiates its frames one after
another (each tile-sharded over its tile group when ``tile_parallel``),
and the gradients of the sum of its frames' losses over B are summed over
the data group (``mesh.sum_data``, one all-reduce of every gradient and the
loss) before the functional Adam; the per-frame outputs the state update
reads are gathered over the data group, so every rank applies the same
update and the states stay bit for bit the same on every rank.

Stage 1's and the static step's frame-parallel counterparts
(``make_dp_stage1_step``, ``make_dp_static_step``, ``stage1_flags``) are not
ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from riggs_tpu_torch.data.dataset import Frame
from riggs_tpu_torch.models import gaussians as G
from riggs_tpu_torch.parallel.mesh import Mesh, shard_batch
from riggs_tpu_torch.train import losses as L
from riggs_tpu_torch.train import optim as O
from riggs_tpu_torch.train.stage2 import Stage2State, stage2_frame_loss


def stack_frames(frames: list[Frame]) -> Frame:
    """One Frame whose tensors (the camera's too) stack the frames' along a
    new leading axis; the frames share their image size and their optional
    fields' presence."""

    def stack(*xs):
        x = xs[0]
        if isinstance(x, torch.Tensor):
            return torch.stack(xs)
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: stack(*(getattr(y, f.name) for y in xs))
                                             for f in dataclasses.fields(x)})
        if any(y != x for y in xs):
            raise ValueError(f"stacked frames differ in {x!r}")
        return x

    return stack(*frames)


def unstack_frame(batch: Frame, b: int) -> Frame:
    """Frame ``b`` of a stacked batch."""

    def row(x):
        if isinstance(x, torch.Tensor):
            return x[b]
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: row(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return x

    return row(batch)


def stage2_flags(warm=False, active_sh=0, enable_to=True, enable_sm=True) -> dict:
    """The schedule flags of a dp stage-2 step: the warm-up, the SH degree
    and the two unlocks (host values, as the single-device step takes
    them)."""
    return dict(warm=bool(warm), active_sh=int(active_sh), enable_to=bool(enable_to), enable_sm=bool(enable_sm))


def make_dp_stage2_step(
    mesh: Mesh,
    use_chamfer: bool = False,
    lambda_chamfer: float = 1e-3,
    lambda_rendering: float = 1.0,
    lambda_dssim: float = 0.2,
    max_per_tile: int = 256,
    isotropic: bool = False,
    tile_parallel: bool = False,
    tile_ladder: tuple | None = None,
):
    """The frame-parallel stage-2 step over ``mesh``:
    ``step(state, frame_batch, uids, bg, lrs_gs, lrs_skel, pre_d_xyz_b,
    pre_d_joints_b, lambda_to, lambda_tf, flags)`` with a stacked batch of B
    frames (B a multiple of the data size) and its (B,) uids, (B, C, 3)
    and (B, J, 3) stage-1 deformations and (B,) per-frame lambdas, every
    rank passing the whole batch. One step applies the mean gradient of the
    B frames' ``stage2_frame_loss``: Adam on the skeleton always, on the
    Gaussians outside the warm-up (in it their parameters and moments stay
    as they are); the densification statistics of every frame in frame
    order, as B single-device steps would add them (each frame's screen
    gradient times B undoes the mean); the batch's chamfers into
    ``proj_loss`` when ``use_chamfer``; ``it`` advanced by B. Returns (new
    state, metrics: the mean loss and PSNR, the summed tile overflow and
    the (B, T) tile counts).

    With ``tile_parallel`` each frame's blend is split over the rank's tile
    group; the ladder permutes tiles by their count, which the tile shards
    do not follow, so the tile-parallel step keeps plain windows
    (``tile_ladder`` is ignored there, as the reference ignores it)."""
    shard_mesh = mesh if tile_parallel else None
    ladder = None if tile_parallel else tile_ladder

    def step(state: Stage2State, frame_batch: Frame, uids, bg, lrs_gs: dict, lrs_skel, pre_d_xyz_b, pre_d_joints_b,
             lambda_to, lambda_tf, flags: dict):
        uids = [int(u) for u in uids]
        B = len(uids)
        local = shard_batch(dict(frames=frame_batch, uids=torch.arange(B), pdx=pre_d_xyz_b, pdj=pre_d_joints_b,
                                 lto=torch.as_tensor(lambda_to), ltf=torch.as_tensor(lambda_tf)), mesh)
        rows = [int(i) for i in local["uids"]]
        gs_p = {k: v.detach().requires_grad_(True) for k, v in state.gs.params_dict().items()}
        params = {"gs": gs_p, "skel": state.skel.params_dict()}
        m2bs = [torch.zeros_like(state.gs.xyz[:, :2], requires_grad=True) for _ in rows]
        loss = torch.zeros((), device=state.gs.xyz.device)
        per_frame = []
        for i, b in enumerate(rows):
            frame = unstack_frame(local["frames"], i)
            loss_b, (out, aux, _) = stage2_frame_loss(
                params, state, frame, uids[b], bg, m2bs[i], local["pdx"][i], local["pdj"][i],
                float(local["lto"][i]), float(local["ltf"][i]),
                lambda_chamfer=lambda_chamfer, lambda_rendering=lambda_rendering, warm=flags["warm"],
                active_sh=flags["active_sh"], enable_to=flags["enable_to"], enable_sm=flags["enable_sm"],
                use_chamfer=use_chamfer, lambda_dssim=lambda_dssim, max_per_tile=max_per_tile,
                isotropic=isotropic, tile_shard_mesh=shard_mesh, tile_ladder=ladder,
            )
            loss = loss + loss_b / B
            per_frame.append((out, aux, frame))
        gp, gm2b = O.grad_tree(loss, (params, m2bs))
        with torch.no_grad():
            # one all-reduce over the data group: every gradient and the loss
            leaves = O.tree_leaves(gp) + [loss.detach()]
            flat = mesh.sum_data(torch.cat([x.reshape(-1) for x in leaves]))
            parts = iter(torch.split(flat, [x.numel() for x in leaves]))
            gp = O.tree_map(lambda x: next(parts).view_as(x), gp)
            loss = next(parts).view(())
            # the per-frame outputs of the whole batch, in frame order
            pf = {
                "gm2b": torch.stack(gm2b), "radii": torch.stack([o["radii"] for o, _, _ in per_frame]),
                "visible": torch.stack([o["visibility_filter"] for o, _, _ in per_frame]).to(torch.uint8),
                "psnr": torch.stack([L.psnr(o["render"], f.image) for o, _, f in per_frame]),
                "chamfer": torch.stack([a["chamfer"] if "chamfer" in a else torch.zeros((), device=loss.device)
                                        for _, a, _ in per_frame]),
                "overflow_tiles": torch.stack([o["overflow_tiles"] for o, _, _ in per_frame]),
                "tile_counts": torch.stack([o["tile_counts"] for o, _, _ in per_frame]),
            }
            pf = {k: mesh.gather_data(v) for k, v in pf.items()}
            pf["visible"] = pf["visible"].bool()

            new_skel_p, opt_skel = O.adam_update(gp["skel"], state.opt_skel, params["skel"], lrs_skel)
            if flags["warm"]:
                gs, opt_gs = state.gs, state.opt_gs
            else:
                new_gs_p, opt_gs = O.adam_update(gp["gs"], state.opt_gs, gs_p, lrs_gs)
                gs = state.gs.replace_params(new_gs_p)
            cam = frame_batch.cam
            stats = state.stats_gs
            for b in range(B):
                stats = G.add_densification_stats(stats, pf["gm2b"][b] * B, pf["radii"][b], pf["visible"][b],
                                                  cam.width, cam.height)
            proj_loss = state.proj_loss
            if use_chamfer:
                proj_loss = proj_loss.clone()
                proj_loss[torch.as_tensor(uids, device=proj_loss.device)] = pf["chamfer"]
        new_state = Stage2State(gs=gs, skel=state.skel.replace_params(new_skel_p), opt_gs=opt_gs, opt_skel=opt_skel,
                                stats_gs=stats, proj_loss=proj_loss, it=state.it + B)
        return new_state, {"loss": loss, "psnr": torch.mean(pf["psnr"]),
                           "overflow_tiles": torch.sum(pf["overflow_tiles"]), "tile_counts": pf["tile_counts"]}

    return step
