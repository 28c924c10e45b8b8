"""The frame-parallel training steps over a data x tile mesh.

Port of ``riggs_tpu/parallel/train.py`` (``stack_frames``, ``stage2_flags``,
``make_dp_stage2_step``, ``stage1_flags``, ``make_dp_stage1_step``,
``make_dp_static_step``). The reference's steps vmap the per-frame loss
over a batch of B frames sharded over the mesh's ``data`` axis and take the
mean, and XLA turns the mean's gradient into a sum over the devices. Here
each rank of a data group takes its rows of the batch (``mesh.shard_batch``),
renders and differentiates its frames one after another (the stage-2 step's
each tile-sharded over its tile group when ``tile_parallel``), and the
gradients of the sum of its frames' losses over B are summed over the data
group (``mesh.sum_data``, one all-reduce of every gradient and the loss)
before the functional Adam; the per-frame outputs the state update reads
are gathered over the data group in frame order, so every rank applies the
same update and the states stay bit for bit the same on every rank. The
stage-1 and static steps use the ``data`` axis only, as the reference's do.
"""
from __future__ import annotations

import dataclasses

import torch

from riggs_tpu_torch.data.dataset import Frame
from riggs_tpu_torch.models import gaussians as G
from riggs_tpu_torch.parallel.mesh import Mesh, shard_batch
from riggs_tpu_torch.render.api import render
from riggs_tpu_torch.train import losses as L
from riggs_tpu_torch.train import optim as O
from riggs_tpu_torch.train.stage1 import Stage1State, stage1_frame_loss
from riggs_tpu_torch.train.stage2 import Stage2State, stage2_frame_loss
from riggs_tpu_torch.train.static import TrainState


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


def _sum_over_data(mesh: Mesh, grads, loss: torch.Tensor):
    """One all-reduce over the data group of every gradient leaf and the
    loss; returns (summed gradients, summed loss)."""
    leaves = O.tree_leaves(grads) + [loss.detach()]
    flat = mesh.sum_data(torch.cat([x.reshape(-1) for x in leaves]))
    parts = iter(torch.split(flat, [x.numel() for x in leaves]))
    grads = O.tree_map(lambda x: next(parts).view_as(x), grads)
    return grads, next(parts).view(())


def _add_frame_grads(acc, loss_b: torch.Tensor, params, *extra):
    """The gradient of one frame's share of the loss in ``params`` (and in
    the ``extra`` tensors), added to ``acc`` (None for the first frame).
    Each frame is differentiated on its own and the frames' gradients are
    summed in frame order, so a rank's gradient is the same sum whether
    the data group splits the batch or one rank takes it all, and one
    frame's graph is alive at a time. Returns (the sum, the gradients of
    ``extra``)."""
    grads = O.grad_tree(loss_b, (params, *extra))
    g = grads[0]
    if acc is not None:
        with torch.no_grad():
            g = O.tree_map(torch.add, acc, g)
    return g, *grads[1:]


def _gather_frames(mesh: Mesh, per_frame: dict) -> dict:
    """Each per-frame output of the rank's frames, stacked and gathered
    over the data group: the whole batch's, in frame order (the
    visibility masks cross as uint8)."""
    pf = {k: mesh.gather_data(torch.stack(v).to(torch.uint8) if k == "visible" else torch.stack(v))
          for k, v in per_frame.items()}
    pf["visible"] = pf["visible"].bool()
    return pf


def _add_stats(stats: G.DensifyStats, pf: dict, cam) -> G.DensifyStats:
    """The densification statistics of every frame of the batch in frame
    order, as B single-device steps add them: each frame's screen gradient
    times B undoes the mean over the batch."""
    B = pf["gm2b"].shape[0]
    for b in range(B):
        stats = G.add_densification_stats(stats, pf["gm2b"][b] * B, pf["radii"][b], pf["visible"][b], cam.width,
                                          cam.height)
    return stats


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
    rank passing the whole batch (the frames may be its rows instead, a
    ``mesh.LocalRows``). One step applies the mean gradient of the
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
            gp, loss = _sum_over_data(mesh, gp, loss)
            zero = torch.zeros((), device=loss.device)
            pf = _gather_frames(mesh, {
                "gm2b": gm2b, "radii": [o["radii"] for o, _, _ in per_frame],
                "visible": [o["visibility_filter"] for o, _, _ in per_frame],
                "psnr": [L.psnr(o["render"], f.image) for o, _, f in per_frame],
                "chamfer": [a.get("chamfer", zero) for _, a, _ in per_frame],
                "overflow_tiles": [o["overflow_tiles"] for o, _, _ in per_frame],
                "tile_counts": [o["tile_counts"] for o, _, _ in per_frame],
            })
            new_skel_p, opt_skel = O.adam_update(gp["skel"], state.opt_skel, params["skel"], lrs_skel)
            if flags["warm"]:
                gs, opt_gs = state.gs, state.opt_gs
            else:
                new_gs_p, opt_gs = O.adam_update(gp["gs"], state.opt_gs, gs_p, lrs_gs)
                gs = state.gs.replace_params(new_gs_p)
            stats = _add_stats(state.stats_gs, pf, local["frames"].cam)
            proj_loss = state.proj_loss
            if use_chamfer:
                proj_loss = proj_loss.clone()
                proj_loss[torch.as_tensor(uids, device=proj_loss.device)] = pf["chamfer"]
        new_state = Stage2State(gs=gs, skel=state.skel.replace_params(new_skel_p), opt_gs=opt_gs, opt_skel=opt_skel,
                                stats_gs=stats, proj_loss=proj_loss, it=state.it + B)
        return new_state, {"loss": loss, "psnr": torch.mean(pf["psnr"]),
                           "overflow_tiles": torch.sum(pf["overflow_tiles"]), "tile_counts": pf["tile_counts"]}

    return step


def stage1_flags(warm=False, active_sh=0) -> dict:
    """The schedule flags of a dp stage-1 phase-B step: the warm-up and the
    SH degree (host values)."""
    return dict(warm=bool(warm), active_sh=int(active_sh))


def make_dp_stage1_step(
    mesh: Mesh,
    use_chamfer: bool = False,
    use_motion_loss: bool = False,
    use_flow_loss: bool = False,
    lambda_chamfer: float = 1e-3,
    lambda_dssim: float = 0.2,
    max_per_tile: int = 1024,
    isotropic: bool = False,
    tile_ladder: tuple | None = None,
):
    """The frame-parallel stage-1 phase-B step over ``mesh``'s data axis:
    ``step(state, frame_batch, bg, lrs_gs, lrs_warp, arap_ts, lambda_arap,
    lambda_motion, lambda_flow_b, flags)`` with a stacked batch of B frames
    (B a multiple of the data size), every rank passing the whole batch.
    ``arap_ts`` (B, t_samp_num) holds each frame's ARAP sample times, drawn
    by the caller (where the reference takes (B, 2) keys); ``lambda_flow_b``
    (B,) each frame's flow weight, 0 for a frame that drew no partner (its
    flow arrays zero: with ``use_flow_loss`` every frame carries them). One
    step applies the mean gradient of the B frames' ``stage1_frame_loss``
    (photometric, landmark-scheduled ARAP, motion mask, chamfer, flow):
    Adam on the Gaussians and on the warp with their per-group learning
    rates; the densification statistics of every frame in frame order, as
    B single-device steps would add them. Returns (new state, metrics: the
    mean loss and PSNR, the summed tile and rect overflow, the (B, T) tile
    counts)."""

    def step(state: Stage1State, frame_batch: Frame, bg, lrs_gs: dict, lrs_warp: dict, arap_ts, lambda_arap,
             lambda_motion, lambda_flow_b, flags: dict):
        B = arap_ts.shape[0]
        local = shard_batch(dict(frames=frame_batch, arap_t=arap_ts,
                                 lam_flow=torch.as_tensor(lambda_flow_b, dtype=torch.float32)), mesh)
        gs_p = {k: v.detach().requires_grad_(True) for k, v in state.gs.params_dict().items()}
        params = {"gs": gs_p, "warp": state.warp.params_dict()}
        loss = torch.zeros((), device=state.gs.xyz.device)
        gp, gm2b, outs = None, [], []
        for i in range(local["arap_t"].shape[0]):
            frame = unstack_frame(local["frames"], i)
            m2b = torch.zeros_like(state.gs.xyz[:, :2], requires_grad=True)
            loss_b, (out, _) = stage1_frame_loss(
                params, state, frame, bg, m2b, local["arap_t"][i], float(lambda_arap), float(lambda_motion),
                lambda_flow=float(local["lam_flow"][i]), lambda_chamfer=lambda_chamfer, warm=flags["warm"],
                active_sh=flags["active_sh"], use_chamfer=use_chamfer, use_motion_loss=use_motion_loss,
                use_flow_loss=use_flow_loss, lambda_dssim=lambda_dssim, max_per_tile=max_per_tile,
                isotropic=isotropic, tile_ladder=tile_ladder,
            )
            gp, g_m2b = _add_frame_grads(gp, loss_b / B, params, m2b)
            loss = loss + loss_b.detach() / B
            gm2b.append(g_m2b)
            outs.append((out, frame))
        with torch.no_grad():
            gp, loss = _sum_over_data(mesh, gp, loss)
            pf = _gather_frames(mesh, {
                "gm2b": gm2b, "radii": [o["radii"] for o, _ in outs], "visible": [o["visibility_filter"] for o, _ in outs],
                "psnr": [L.psnr(o["render"], f.image) for o, f in outs],
                "overflow_tiles": [o["overflow_tiles"] for o, _ in outs],
                "overflow_rect": [o["overflow_rect"] for o, _ in outs],
                "tile_counts": [o["tile_counts"] for o, _ in outs],
            })
            new_gs_p, opt_gs = O.adam_update(gp["gs"], state.opt_gs, gs_p, lrs_gs)
            new_warp_p, opt_warp = O.adam_update(gp["warp"], state.opt_warp, params["warp"], lrs_warp)
            stats = _add_stats(state.stats_gs, pf, local["frames"].cam)
        new_state = dataclasses.replace(state, gs=state.gs.replace_params(new_gs_p),
                                        warp=state.warp.replace_params(new_warp_p), opt_gs=opt_gs, opt_warp=opt_warp,
                                        stats_gs=stats)
        return new_state, {"loss": loss, "psnr": torch.mean(pf["psnr"]),
                           "overflow_tiles": torch.sum(pf["overflow_tiles"]),
                           "overflow_rect": torch.sum(pf["overflow_rect"]), "tile_counts": pf["tile_counts"]}

    return step


def make_dp_static_step(mesh: Mesh, active_sh: int = 0, lambda_dssim: float = 0.2, max_per_tile: int = 256):
    """The frame-parallel static-3DGS step over ``mesh``'s data axis:
    ``step(state, frame_batch, bg, lr)`` (a ``TrainState``, a stacked batch
    of B frames or the rank's rows of it as a ``mesh.LocalRows``, one
    learning rate for every group) applies the mean
    gradient of the B frames' photometric loss with Adam; the statistics
    stay as they are, as the reference's do. Returns (new state, the mean
    loss)."""

    def step(state: TrainState, frame_batch: Frame, bg, lr):
        local = shard_batch(frame_batch, mesh)
        B = local.image.shape[0] * mesh.shape["data"]
        params = {k: v.detach().requires_grad_(True) for k, v in state.gs.params_dict().items()}
        gs = state.gs.replace_params(params)
        loss = torch.zeros((), device=state.gs.xyz.device)
        grads = None
        for i in range(local.image.shape[0]):
            frame = unstack_frame(local, i)
            out = render(frame.cam, gs, bg, active_sh_degree=active_sh, max_per_tile=max_per_tile)
            loss_b = L.photometric_loss(out["render"], frame.image, lambda_dssim)
            (grads,) = _add_frame_grads(grads, loss_b / B, params)
            loss = loss + loss_b.detach() / B
        with torch.no_grad():
            grads, loss = _sum_over_data(mesh, grads, loss)
            new_p, opt = O.adam_update(grads, state.opt, params, lr)
        return TrainState(gs=state.gs.replace_params(new_p), opt=opt, stats=state.stats), loss

    return step
