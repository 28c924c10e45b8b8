"""Stage-2 (rigged) training step and held-out render.

Port of ``riggs_tpu/train/stage2.py``: ``Stage2State``,
``sample_skeleton_points``, ``stage2_frame_loss`` (photometric + template
offsets + robust 2D-skeleton chamfer + template-fixed pose loss, or the
warmup distillation toward the stage-1 deformations), ``stage2_step`` (value
and gradient, Adam on the skeleton and, outside warmup, on the Gaussians,
densification statistics), ``stage2_flags`` (the staged flags and lambdas
of an iteration) and ``make_stage2_auto`` (every schedule derived from
the caller's iteration count); ``_eval_image`` and ``eval_image``; then the
pipeline from a trained stage-1 state: ``PretrainInfo`` and
``precompute_deformations`` (the stage-1 deformation of every train frame,
the nodes' semantic labels, the template frame, skeleton extraction),
``init_stage2`` (the template bake, the skeleton and fresh optimizer
state), ``evaluate_stage2`` and the loop ``train_stage2`` with its
``Stage2Draws``. Checkpoints, logging and resume are not ported yet.

The staged flags (``warm``, ``enable_to``, ``enable_sm``, ``use_chamfer``,
``active_sh``) are host values: eager PyTorch has no compiled program whose
recompilation the reference's traced 0/1 weights avoid. A python ``False``
keeps an optional MLP out of the graph, where the reference keeps it in at
weight 0; both give its parameters a zero gradient.

The skeleton's parameters are its ``nn.Module``'s own and are updated in
place (``SkeletonWarp.replace_params``): ``stage2_step`` consumes the state
it is given, whose ``skel`` the returned state shares. ``make_stage2_auto``'s
step consumes the whole state: it runs ``stage2_step`` on buffers of its own
(``train/step_graph.py``), copies in a state whose tensors are not those
buffers, and returns a state whose every tensor is one of them, overwritten
in place by its next call. On the card it replays the step as a CUDA graph.

``eval_image`` always ends. The reference loops forever on a persistent
``overflow_rect`` while ``tiers`` is set (the tiers tuple overrides the
escalated ``max_tiles_per_gaussian``), and on a persistent ``overflow_tiles``
once ``max_per_tile`` is at its limit (8192) with the rect cap below its own.
Here a rect overflow under tiers drops the tiers, the window grows
past 8192 to the observed max count as far as the device's free memory
allows (``window_ceiling``), and only a render that cannot escalate further
is returned, with a warning.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any

import numpy as np
import torch

from riggs_tpu_torch import trace
from riggs_tpu_torch.camera.camera import project_nodes_2d
from riggs_tpu_torch.data.dataset import Frame, SceneData
from riggs_tpu_torch.device import constant, resolve_device, static_index
from riggs_tpu_torch.eval.metrics import evaluate_image
from riggs_tpu_torch.models import gaussians as G
from riggs_tpu_torch.models import node_warp as NW
from riggs_tpu_torch.models import skeleton_warp as SW
from riggs_tpu_torch.ops.fps import farthest_point_sample
from riggs_tpu_torch.ops.knn import chamfer_distance
from riggs_tpu_torch.render.api import render, tier_kwargs
from riggs_tpu_torch.render.binning import TILE
from riggs_tpu_torch.render.blend import fwd_scratch_bytes
from riggs_tpu_torch.render.ladder import LadderPolicy
from riggs_tpu_torch.skeleton.extract import fps_on, obtain_skeleton_tree
from riggs_tpu_torch.train import losses as L
from riggs_tpu_torch.train import optim as O
from riggs_tpu_torch.train import schedule as S
from riggs_tpu_torch.train.config import Config
from riggs_tpu_torch.train.sampling import FrameSampler
from riggs_tpu_torch.train.stage1 import _overflow
from riggs_tpu_torch.train.static import SplitDraws, TrainState, densify_step
from riggs_tpu_torch.train.step_graph import StaticStep, layout

MAX_PER_TILE_LIMIT = 8192
MAX_TILES_LIMIT = 1024


@dataclasses.dataclass
class Stage2State:
    gs: G.Gaussians
    skel: SW.SkeletonWarp
    opt_gs: O.AdamState
    opt_skel: O.AdamState
    stats_gs: G.DensifyStats
    proj_loss: torch.Tensor  # (F,) per-frame chamfer history for the robust weights
    it: torch.Tensor  # () int32 iteration counter; stage2_step increments it


def stage2_leaves(state: Stage2State) -> dict[str, tuple[torch.Tensor, bool]]:
    """Every tensor of a stage-2 state under the key ``jax.tree_util.keystr``
    gives it in ``riggs_tpu`` (the checkpoints' table, ``io/checkpoint.py``):
    key -> (the state's own tensor, whether it is stored transposed). Absent
    MLPs have no leaves."""
    out: dict = {}
    O.named_fields(state.gs, G.Gaussians.TENSORS, ".gs", out)
    skel = state.skel
    O.named_fields(skel, ("joints", "node_radius_log"), ".skel", out)
    for name in ("pose_mlp", "weight_mlp", "detail_mlp"):
        if getattr(skel, name) is not None:
            O.named_leaves(getattr(skel, name).params_dict(), f".skel.{name}", out)
    O.named_fields(skel, ("control_nodes",), ".skel", out)
    O.adam_leaves(state.opt_gs, ".opt_gs", out)
    O.adam_leaves(state.opt_skel, ".opt_skel", out)
    O.named_fields(state.stats_gs, G.DensifyStats.TENSORS, ".stats_gs", out)
    return O.named_fields(state, ("proj_loss", "it"), "", out)


def sample_skeleton_points(joints: torch.Tensor, parents, samples_per_bone: int = 8) -> torch.Tensor:
    """``samples_per_bone`` points along every bone (parent to child joint)
    for the 2D-projection chamfer."""
    a = joints[static_index(tuple(int(p) for p in parents[1:]), joints.device)]
    b = joints[1:]
    t = torch.linspace(0.0, 1.0, samples_per_bone, device=joints.device)[:, None, None]
    pts = (1.0 - t) * a[None] + t * b[None]
    return pts.reshape(-1, 3)


def _row(t: torch.Tensor, uid: int | torch.Tensor) -> torch.Tensor:
    """``t[uid]`` for a host ``uid`` or a one-element int64 index on the
    device (an ``index_select``: a 0-dim device index in ``[]`` may be read
    back to the host)."""
    return t.index_select(0, uid)[0] if isinstance(uid, torch.Tensor) else t[uid]


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values of an even-length
    input (``torch.median`` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) / 2.0


def stage2_frame_loss(
    params: dict,
    state: Stage2State,
    frame: Frame,
    uid: int | torch.Tensor,
    bg: torch.Tensor,
    mean2d_bias: torch.Tensor,
    pre_d_xyz: torch.Tensor,
    pre_d_joints: torch.Tensor,
    lambda_template_offsets: float,
    lambda_template_fixed: float,
    lambda_chamfer: float = 1e-3,
    lambda_rendering: float = 1.0,
    warm: bool = False,
    active_sh: int = 0,
    enable_to: bool = False,
    enable_sm: bool = False,
    use_chamfer: bool = True,
    lambda_dssim: float = 0.2,
    max_per_tile: int = 1024,
    isotropic: bool = False,
    tile_shard_mesh=None,
    tile_ladder: tuple | None = None,
    tiers: tuple | None = None,
):
    """The per-frame stage-2 loss. ``params`` is ``{"gs": ..., "skel": ...}``
    in the ``params_dict`` trees (``params["skel"]`` is written into
    ``state.skel`` unless it holds the module's own parameters).
    ``tile_shard_mesh`` (a ``parallel.mesh.Mesh``) blends the frame's tiles
    across the mesh's tile group. Returns (loss, (render output, aux losses,
    deformation))."""
    gs = state.gs.replace_params(params["gs"])
    skel = state.skel.replace_params(params["skel"])
    with trace.span("riggs.deform.skeleton"):
        d = SW.skeleton_forward(
            skel, gs.xyz.detach(), frame.fid, gs.motion_mask,
            enable_template_offsets=enable_to, enable_skinning_mlp=enable_sm,
        )
    d_xyz, d_rot = d["d_xyz"], d["d_rotation"]
    d_scaling = torch.zeros_like(d["d_scaling"])
    if isotropic:
        d_rot = torch.zeros_like(d_rot)
    with trace.span("riggs.loss.regularizers"):
        loss = torch.zeros((), device=gs.device)
        aux = {}
        if state.skel.net.use_template_offsets:
            # a disabled detail net gives exactly zero offsets, so the term vanishes
            to_loss = torch.mean(d["template_offsets"] ** 2)
            loss = loss + lambda_template_offsets * to_loss
            aux["template_offsets_loss"] = to_loss
        if frame.thinned is not None:
            pts = sample_skeleton_points(d["d_nodes"], state.skel.net.parents)
            proj = project_nodes_2d(frame.cam, pts)
            cd = chamfer_distance(proj, frame.thinned, y_mask=frame.thinned_mask, norm=1)
            # robust per-frame weight from the running loss buffer
            sigma = _median(state.proj_loss) / 2.0
            w = torch.exp(-_row(state.proj_loss, uid) ** 2 / (2.0 * sigma**2))
            loss = loss + lambda_chamfer * float(use_chamfer) * w * cd
            aux["chamfer"] = cd
        # template-fixed pose loss (identity local rotation on the template frame)
        tf_loss = torch.mean((d["local_rotation"] - constant(SW.ROT_BIAS, d["local_rotation"])) ** 2)
        loss = loss + lambda_template_fixed * tf_loss

    out = render(
        frame.cam, gs, bg,
        d_xyz=d_xyz, d_rotation=d_rot, d_scaling=d_scaling,
        active_sh_degree=active_sh, mean2d_bias=mean2d_bias, max_per_tile=max_per_tile,
        tile_shard_mesh=tile_shard_mesh, tile_ladder=tile_ladder, **tier_kwargs(tiers),
    )
    # warmup distils toward the precomputed stage-1 deformation, the main
    # phase trains photometric (both terms are computed, one weighted 0)
    w_warm = float(warm)
    with trace.span("riggs.loss.regularizers"):
        aux["d_xyz_loss"] = L.l2_loss(d_xyz, pre_d_xyz)
        aux["d_node_loss"] = L.l2_loss(d["d_nodes"], pre_d_joints)
        loss = loss + w_warm * (aux["d_xyz_loss"] + aux["d_node_loss"])
    with trace.span("riggs.loss.photometric"):
        img_loss = L.photometric_loss(out["render"], frame.image, lambda_dssim)
        aux["img_loss"] = img_loss
        loss = loss + (1.0 - w_warm) * lambda_rendering * img_loss
    return loss, (out, aux, d)


def stage2_step(
    state: Stage2State,
    frame: Frame,
    uid: int | torch.Tensor,
    bg: torch.Tensor,
    lrs_gs: dict,
    lrs_skel: Any,
    pre_d_xyz: torch.Tensor,
    pre_d_joints: torch.Tensor,
    lambda_template_offsets: float,
    lambda_template_fixed: float,
    lambda_chamfer: float = 1e-3,
    lambda_rendering: float = 1.0,
    warm: bool = False,
    active_sh: int = 0,
    enable_to: bool = False,
    enable_sm: bool = False,
    use_chamfer: bool = True,
    lambda_dssim: float = 0.2,
    max_per_tile: int = 1024,
    isotropic: bool = False,
    tile_ladder: tuple | None = None,
    tiers: tuple | None = None,
):
    """One stage-2 step: value and gradient of ``stage2_frame_loss`` in the
    Gaussians, the skeleton and ``mean2d_bias``; Adam on the skeleton always
    and on the Gaussians outside warmup (in warmup their parameters and
    moments stay as they are); the densification statistics; the frame's
    chamfer in ``proj_loss``. ``uid`` may be a one-element int64 index on
    the device, and a learning rate a 0-dim float32 tensor there. Returns
    (new state, metrics)."""
    with trace.span("riggs.entry.stage2_step"):
        gs_p = {k: v.detach().requires_grad_(True) for k, v in state.gs.params_dict().items()}
        params = {"gs": gs_p, "skel": state.skel.params_dict()}
        m2b = torch.zeros_like(state.gs.xyz[:, :2], requires_grad=True)
        loss, (out, aux, d) = stage2_frame_loss(
            params, state, frame, uid, bg, m2b, pre_d_xyz, pre_d_joints,
            lambda_template_offsets, lambda_template_fixed,
            lambda_chamfer=lambda_chamfer, lambda_rendering=lambda_rendering,
            warm=warm, active_sh=active_sh, enable_to=enable_to, enable_sm=enable_sm,
            use_chamfer=use_chamfer, lambda_dssim=lambda_dssim, max_per_tile=max_per_tile,
            isotropic=isotropic, tile_ladder=tile_ladder, tiers=tiers,
        )
        with trace.span("riggs.backward.grad"):
            gp, gm2b = O.grad_tree(loss, (params, m2b))
        with trace.span("riggs.optim.adam"), torch.no_grad():
            new_skel_p, opt_skel = O.adam_update(gp["skel"], state.opt_skel, params["skel"], lrs_skel)
            if warm:
                gs, opt_gs = state.gs, state.opt_gs
            else:
                new_gs_p, opt_gs = O.adam_update(gp["gs"], state.opt_gs, gs_p, lrs_gs)
                gs = state.gs.replace_params(new_gs_p)
            stats = G.add_densification_stats(
                state.stats_gs, gm2b, out["radii"], out["visibility_filter"],
                frame.cam.width, frame.cam.height,
            )
            proj_loss = state.proj_loss
            if "chamfer" in aux:
                proj_loss = proj_loss.clone()
                if isinstance(uid, torch.Tensor):
                    proj_loss.index_put_((uid,), aux["chamfer"].reshape(1))
                else:
                    proj_loss[uid] = aux["chamfer"]
            metrics = {"loss": loss.detach(), "psnr": L.psnr(out["render"], frame.image), "n_gs": state.gs.num_alive}
            metrics.update({k: v.detach() for k, v in aux.items()})
            new_state = Stage2State(
                gs=gs,
                skel=state.skel.replace_params(new_skel_p),
                opt_gs=opt_gs,
                opt_skel=opt_skel,
                stats_gs=stats,
                proj_loss=proj_loss,
                it=state.it + 1,
            )
        # ladder policy inputs: true per-tile hit counts and truncation counters
        metrics["overflow_tiles"] = out["overflow_tiles"]
        metrics["overflow_rect"] = out["overflow_rect"]
        metrics["tile_counts"] = out["tile_counts"]
    return new_state, metrics


def stage2_flags(cfg: Config, it: int, uid: int, template_idx: int) -> dict:
    """The staged flags and lambdas of iteration ``it`` for frame ``uid``, as
    ``make_stage2_auto`` derives them (keyword arguments of
    ``stage2_frame_loss`` and ``stage2_step``): the skeleton warmup, the
    unlock of the template offsets and the skinning MLP (where the model has
    them), the SH degree, the template-frame lambdas (x1e3 template offsets,
    the template-fixed loss) and the render tiers."""
    o, m, pipe = cfg.opt, cfg.model, cfg.pipe
    is_t = uid == template_idx
    return dict(
        lambda_template_offsets=o.lambda_template_offsets * (1e3 if is_t else 1.0),
        lambda_template_fixed=o.lambda_template_fixed if is_t else 0.0,
        lambda_chamfer=o.lambda_deformed_node_prjection,
        lambda_rendering=o.lambda_rendering_image,
        warm=it < o.skeleton_warm_up,
        active_sh=min(it // o.oneupSHdegree_step, m.sh_degree),
        enable_to=it >= o.optimize_template_offsets_iters if m.use_template_offsets else False,
        enable_sm=it > o.optimize_template_offsets_iters if m.use_skinning_weight_mlp else False,
        tiers=(pipe.max_tiles_per_gaussian, pipe.mid_cap, pipe.mid_side),
    )


def _static(state: Stage2State) -> tuple:
    """A stage-2 state's static fields: what its buffers hold besides the
    leaves."""
    g = state.gs
    return (g.device, g.max_sh_degree, g.isotropic, g.with_motion_mask, g.shared_scale, state.skel.net)


def make_stage2_auto(cfg: Config, template_idx: int):
    """The stage-2 step with every schedule derived from the host iteration
    ``it`` (the caller owns the count; the step still increments the device
    ``state.it``): the learning rates and the flags of ``stage2_flags``.

    The step runs ``stage2_step`` on static buffers (``step_graph.StaticStep``
    over ``stage2_leaves``): the frame, the background, the frame's index (a
    device int64 index) and the rates of ``xyz`` and of the skeleton (device
    float32 scalars) are copied in, and so is the state where its tensors
    are not the buffers; the new state is written back into them and the
    metrics come out as one copy of their packed buffer. On the card it
    runs through ``StepGraphs`` (``step.graphs``): captured as one CUDA
    graph after the eager calls of its key, then replayed. The key holds
    everything the graph bakes in: the capacity, the frame's layout (H x W,
    the padded thinned length), the background's, the identity of
    ``pre_d_xyz_all`` and ``pre_d_joints_all`` (read in place at the index),
    every keyword and flag of the step (the ladder, ``max_per_tile``, the
    tiers, the template frame's lambdas) and the device; the state's layout
    belongs to the buffers, whose graphs are dropped with them."""
    o = cfg.opt
    gs_lr = S.expon_lr_f32(o.position_lr_init, o.position_lr_final,
                           lr_delay_mult=o.position_lr_delay_mult, max_steps=o.position_lr_max_steps)
    skel_lr = S.expon_lr_f32(o.deform_mlp_lr_init, o.deform_mlp_lr_final,
                             lr_delay_mult=o.deform_mlp_lr_delay_mult, max_steps=o.deform_mlp_lr_max_steps)
    static = StaticStep(stage2_leaves, _static)

    def step(state, frame, uid, bg, pre_d_xyz_all, pre_d_joints_all, *, it: int, use_chamfer=True,
             lambda_dssim=0.2, max_per_tile=1024, isotropic=False, tile_ladder=None):
        with trace.span("riggs.entry.stage2_auto"):
            flags = stage2_flags(cfg, it, uid, template_idx)
            sb = static.load(state)
            fr, fr_key = sb.frame(frame)
            bg_buf, bg_key = sb.input("bg", bg)
            uid_buf = sb.scalar("uid", int(uid), torch.int64, (1,))
            lrs_gs = {
                "xyz": sb.scalar("lr_xyz", gs_lr(it)),
                "f_dc": o.feature_lr,
                "f_rest": o.feature_lr / 20.0,
                "opacity": o.opacity_lr,
                "scaling": o.scaling_lr,
                "rotation": o.rotation_lr,
                "feature": o.feature_lr,
            }
            lr_skel = sb.scalar("lr_skel", 5e-4 if flags["warm"] else skel_lr(max(it - o.skeleton_warm_up, 0)))
            kw = dict(use_chamfer=use_chamfer, lambda_dssim=lambda_dssim, max_per_tile=max_per_tile,
                      isotropic=isotropic, tile_ladder=tile_ladder, **flags)
            key = (sb.device, state.gs.capacity, fr_key, bg_key, layout(pre_d_xyz_all), layout(pre_d_joints_all),
                   tuple(sorted(kw.items())))

            def body():
                new, metrics = stage2_step(sb.state, fr, uid_buf, bg_buf, lrs_gs, lr_skel,
                                           _row(pre_d_xyz_all, uid_buf), _row(pre_d_joints_all, uid_buf), **kw)
                sb.keep(new)
                sb.pack(key, metrics)

            return static.run(key, body)

    step.graphs = static.graphs
    return step


@torch.no_grad()
def _eval_image(gs, skel, cam, t, bg, max_per_tile=512, max_tiles_per_gaussian=16,
                tile_ladder=None, tiers=None):
    """One skeleton_forward + render; returns (image, overflow_tiles,
    overflow_rect, max_count)."""
    d = SW.skeleton_forward(skel, gs.xyz, t, gs.motion_mask)
    kw = dict(max_tiles_per_gaussian=max_tiles_per_gaussian) if tiers is None else tier_kwargs(tiers)
    out = render(
        cam, gs, bg,
        d_xyz=d["d_xyz"],
        d_rotation=d["d_rotation"],
        d_scaling=torch.zeros_like(d["d_scaling"]),
        active_sh_degree=gs.max_sh_degree,
        max_per_tile=max_per_tile,
        tile_ladder=tile_ladder,
        **kw,
    )
    return out["render"], out["overflow_tiles"], out["overflow_rect"], out["max_count"]


def window_ceiling(device: torch.device, n_tiles: int) -> int:
    """The largest plain window (a multiple of 128 rows) whose forward
    scratch (``blend.fwd_scratch_bytes``) and (T, MAX, 16) f32 gathered
    windows take at most half of the free memory of ``device``: the card's
    ``mem_get_info`` (which does not wait on the stream), the host's free
    pages on the CPU. The other half is for the render's other buffers."""
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0]
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    per_chunk = fwd_scratch_bytes(n_tiles, 2) - fwd_scratch_bytes(n_tiles, 1) + n_tiles * 128 * 16 * 4
    return max(free // 2 // per_chunk, 1) * 128


def grow_window(max_per_tile: int, max_count, device: torch.device, n_tiles: int) -> int:
    """The next plain window of a frame whose largest tile holds
    ``max_count`` Gaussians: the count rounded up to 128 rows and at least
    twice ``max_per_tile``, up to ``MAX_PER_TILE_LIMIT`` as the reference
    grows it; past that limit the count itself, up to ``window_ceiling``.
    ``max_per_tile`` itself when it cannot grow."""
    need = -(-int(max_count) // 128) * 128
    if need <= MAX_PER_TILE_LIMIT:
        nxt = min(max(need, max_per_tile * 2), MAX_PER_TILE_LIMIT)
    else:
        # the reference stops at its limit; the card's memory allows more
        nxt = max(min(need, window_ceiling(device, n_tiles)), MAX_PER_TILE_LIMIT)
    return max(nxt, max_per_tile)


def escalate_rect(of_t: int, of_r: int, tiles_grown: bool, max_tiles_per_gaussian: int, tiers=None,
                  what: str = "eval_image"):
    """The rest of one escalation step of a frame that overflowed, once its
    tile overflow is answered (``tiles_grown``: its window or ladder grew):
    a rect overflow drops the tiers, then quadruples the rect cap up to
    ``MAX_TILES_LIMIT``. Returns the next (max_tiles_per_gaussian, tiers),
    or None, with a warning that ``what`` is returned truncated, when
    nothing grew."""
    escalated = tiles_grown
    if of_r > 0:
        if tiers is not None:
            tiers, escalated = None, True
        elif max_tiles_per_gaussian < MAX_TILES_LIMIT:
            max_tiles_per_gaussian, escalated = min(max_tiles_per_gaussian * 4, MAX_TILES_LIMIT), True
    if escalated:
        return max_tiles_per_gaussian, tiers
    warnings.warn(f"{what} hit capacity limits (overflow_tiles={of_t}, overflow_rect={of_r}); "
                  "returning truncated render")
    return None


def eval_image(gs, skel, cam, t, bg, max_per_tile=512, max_tiles_per_gaussian=16,
               tile_ladder=None, tiers=None):
    """Held-out render, re-rendered with the offending cap raised until
    nothing is truncated: a truncating ladder is dropped; tile overflow jumps
    the window to the observed max count (``grow_window``); rect overflow
    drops the tiers, then quadruples the rect cap (``escalate_rect``)."""
    while True:
        img, of_t, of_r, max_count = _eval_image(
            gs, skel, cam, t, bg, max_per_tile, max_tiles_per_gaussian,
            tile_ladder=tile_ladder, tiers=tiers,
        )
        of_t, of_r = int(of_t), int(of_r)
        if of_t == 0 and of_r == 0:
            return img
        if tile_ladder is not None:
            tile_ladder = None
            continue
        grown = False
        if of_t > 0:
            nxt = grow_window(max_per_tile, max_count, gs.device, -(-cam.width // TILE) * -(-cam.height // TILE))
            grown, max_per_tile = nxt > max_per_tile, nxt
        caps = escalate_rect(of_t, of_r, grown, max_tiles_per_gaussian, tiers)
        if caps is None:
            return img
        max_tiles_per_gaussian, tiers = caps


# ---------------------------------------------------------------------------
# From a trained stage-1 state to the rigged model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PretrainInfo:
    """The stage-1 deformations of every train frame and the extracted skeleton."""

    d_xyz: torch.Tensor  # (F, C, 3) on the device, the Gaussians' capacity layout
    d_joints: torch.Tensor  # (F, J, 3) on the device, the joints' nodes per frame
    template_idx: int
    joints: np.ndarray  # (J, 3)
    parents: np.ndarray  # (J,), parents[0] = -1
    joint_node_indices: np.ndarray  # (J,) the stage-1 node behind each joint


@torch.no_grad()
def precompute_deformations(stage1_state, scene: SceneData, cfg: Config) -> tuple[PretrainInfo, list[Frame]]:
    """Run the trained node warp over the time-sorted train frames; label
    the nodes by projecting them into each frame's ``semantic_seg`` (the
    median label over frames); pick the template frame (of the 5 frames
    whose nodes lie closest to their mean trajectory, the one with the most
    alpha-mask coverage, unless ``manually_key_frame`` names one); extract
    the skeleton from the node trajectories with the config's ``skeleton_*``
    knobs, its FPS on the state's device. Returns (info, sorted frames).
    The deformations stay on the device; the nodes, labels and masks come
    to the host once."""
    warp, gs = stage1_state.warp, stage1_state.gs
    frames = sorted(scene.train_frames, key=lambda f: float(f.fid))
    all_d_xyz, all_d_nodes, sem_labels = [], [], []
    for f in frames:
        d = NW.warp_forward(warp, gs.xyz, f.fid, gs.feature, gs.motion_mask, local_frame=warp.net.local_frame)
        all_d_xyz.append(d["d_xyz"])
        all_d_nodes.append(d["d_nodes"])
        if f.semantic_seg is not None:
            seg = f.semantic_seg
            proj = project_nodes_2d(f.cam, d["d_nodes"]).to(torch.int64)  # truncation, as numpy's astype
            rows = proj[:, 0].clamp(0, seg.shape[0] - 1)
            cols = proj[:, 1].clamp(0, seg.shape[1] - 1)
            sem_labels.append(seg[rows, cols])
    d_xyz = torch.stack(all_d_xyz)  # (F, C, 3)
    d_nodes_dev = torch.stack(all_d_nodes)  # (F, M, 3)
    d_nodes = d_nodes_dev.cpu().numpy()

    mean_nodes = d_nodes.mean(axis=0, keepdims=True)
    mean_dev = np.linalg.norm(d_nodes - mean_nodes, axis=-1).mean(axis=-1)
    if cfg.opt.manually_key_frame >= 0:
        template_idx = cfg.opt.manually_key_frame
    else:
        cand = np.argsort(mean_dev)[:5]
        if frames[0].alpha_mask is not None:
            coverage = [float(frames[i].alpha_mask.cpu().numpy().sum()) for i in cand]
            template_idx = int(cand[int(np.argmax(coverage))])
        else:
            template_idx = int(cand[0])
    med_seg = None
    if sem_labels:
        med_seg = np.median(torch.stack(sem_labels).cpu().numpy(), axis=0).astype(np.int64)

    o = cfg.opt
    joints, parents, joint_idx = obtain_skeleton_tree(
        d_nodes[template_idx], d_nodes, med_seg,
        max_candidates=o.skeleton_max_candidates, fps_fn=fps_on(d_xyz.device),
        leaf_prune_hops=o.skeleton_leaf_prune_hops, junction_merge_hops=o.skeleton_junction_merge_hops,
        simplify_dist_thres=o.skeleton_simplify_dist_thres, simplify_max_edges=o.skeleton_simplify_max_edges,
    )
    idx = torch.as_tensor(joint_idx, dtype=torch.int64).to(d_xyz.device)
    info = PretrainInfo(d_xyz=d_xyz, d_joints=d_nodes_dev[:, idx], template_idx=template_idx, joints=joints,
                        parents=parents, joint_node_indices=joint_idx)
    return info, frames


@torch.no_grad()
def init_stage2(stage1_state, scene: SceneData, cfg: Config, generator: torch.Generator | None = None,
                device: str | torch.device | None = None) -> tuple[Stage2State, PretrainInfo, list[Frame]]:
    """``precompute_deformations``, then the stage-2 state: the Gaussians
    (an FPS subset when ``num_gs_sample`` > 10) with the template frame's
    deformation baked into their means (and taken off every frame's
    ``d_xyz``), a ``SkeletonWarp`` on the extracted joints whose radii are
    the joints' stage-1 nodes' (its MLPs drawn from ``generator``), fresh
    Adam states and statistics, ``proj_loss`` 1e5. Runs on ``cuda`` unless
    ``device`` says otherwise; the stage-1 state must live there."""
    dev = resolve_device(device)
    info, frames = precompute_deformations(stage1_state, scene, cfg)
    gs = stage1_state.gs
    if cfg.opt.num_gs_sample > 10:
        gs = G.sampling_and_prune(gs, cfg.opt.num_gs_sample)
    template_offsets = info.d_xyz[info.template_idx]
    gs = dataclasses.replace(gs, xyz=gs.xyz + template_offsets)
    info.d_xyz = info.d_xyz - template_offsets[None]
    radius_log = stage1_state.warp.node_radius_log.detach().cpu().numpy()[info.joint_node_indices]
    skel = SW.init_skeleton_warp(
        info.joints, info.parents, node_radius_log=radius_log, K=cfg.opt.skeleton_weight_knn,
        use_skinning_mlp=cfg.model.use_skinning_weight_mlp, use_template_offsets=cfg.model.use_template_offsets,
        n_control_nodes=cfg.model.skeleton_gs_sample_num, generator=generator, device=dev,
    )
    state = Stage2State(
        gs=gs, skel=skel, opt_gs=O.adam_init(gs.params_dict()), opt_skel=O.adam_init(skel.params_dict()),
        stats_gs=G.init_densify_stats(gs.capacity, device=dev),
        proj_loss=torch.full((len(frames),), 1.0e5, device=dev),
        it=torch.zeros((), dtype=torch.int32, device=dev),
    )
    return state, info, frames


def evaluate_stage2(state: Stage2State, test_frames, bg: torch.Tensor, tile_ladder=None) -> dict:
    """Mean psnr, ssim and ms_ssim over the test frames, each rendered by
    ``eval_image`` (which escalates its caps until nothing is truncated)."""
    rows = [evaluate_image(eval_image(state.gs, state.skel, f.cam, f.fid, bg, tile_ladder=tile_ladder), f.image)
            for f in test_frames]
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]} if rows else {}


# the stage-2 loop's one draw is the split noise of each densification
Stage2Draws = SplitDraws


def train_stage2(
    stage1_state,
    scene: SceneData,
    cfg: Config,
    seed: int = 0,
    log_every: int = 0,
    step_callback=None,
    test_every: int = 0,
    model_path=None,
    logger=None,
    resume: bool = False,
    state: Stage2State | None = None,
    draws=None,
    events: list | None = None,
    device: str | torch.device | None = None,
):
    """Train stage 2 from a trained stage-1 state; returns (state, info, history).

    ``init_stage2`` (its skeleton drawn from a generator seeded with
    ``seed``), then ``iterations_stage2`` (or ``iterations``)
    ``make_stage2_auto`` steps on sampled frames: the skeleton warm-up
    (distillation toward the stage-1 deformations, the Gaussians frozen),
    then the photometric phase; at ``optimize_template_offsets_iters`` the
    control nodes are reset to an FPS of the alive Gaussians; the tile
    ladder rides the first steps (``LadderPolicy``), each step's overflow
    read one step late; past the warm-up and ``gs_densification_iterations``
    the Gaussians densify on the usual cadence, with the ladder's
    anticipatory refit; every ``test_every`` steps ``evaluate_stage2`` on
    the test frames. ``history`` holds (it, scalar metrics) every
    ``log_every`` steps.

    ``state`` replaces ``init_stage2``'s state (the pretrain info is still
    computed), ``draws`` the ``Stage2Draws(seed)`` of the split noise.
    ``events``, when given, receives one dict per event: the FPS reset with
    its indices (a device tensor), densifications with the alive counts
    before and after, ladder fits and refits, every step that overflowed and
    each test evaluation. ``step_callback(state, it)``, when given, is
    called after every step. A step with no event reads the card once: the
    previous step's two overflow counters. Runs on ``cuda`` unless
    ``device`` says otherwise.

    With ``model_path``, a test evaluation that beats the best PSNR so far
    saves a checkpoint (the state and its PLY, ``io/checkpoint.py``): the
    only copies of the state to the host. ``logger`` (a ``TrainLogger``)
    gets the ``train_skeleton`` scalars every ``log_every`` steps and the
    ``test`` means at each evaluation. ``resume`` with a ``model_path``
    loads its latest checkpoint into the initial state and continues from
    its iteration; a checkpoint inside the warm-up, none, or one that does
    not fit (``KeyError``, ``ValueError``) means training from the initial
    state at 0. The frame sampler and the split noise start fresh from
    ``seed`` either way, as the reference's do."""
    o = cfg.opt
    dev = resolve_device(device)
    log = (lambda **e: events.append(e)) if events is not None else (lambda **e: None)
    init, info, frames = init_stage2(stage1_state, scene, cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                                     device=dev)
    state = init if state is None else state
    start_it = 0
    if resume and model_path is not None:
        from riggs_tpu_torch.io.checkpoint import load_checkpoint

        try:
            loaded, start_it = load_checkpoint(model_path, state)
            if start_it < o.skeleton_warm_up:
                raise FileNotFoundError(f"checkpoint at {start_it} inside the warm-up")
            state = loaded
            log(it=start_it, event="resume")
        except (FileNotFoundError, ValueError, KeyError) as e:
            start_it = 0
            log(it=0, event="no resume", reason=str(e))
    draws = Stage2Draws(seed, dev) if draws is None else draws
    bg = torch.ones(3, device=dev) if scene.white_background else torch.zeros(3, device=dev)
    sampler = FrameSampler(frames, np.random.default_rng(seed))
    step_auto = make_stage2_auto(cfg, int(info.template_idx))
    state = dataclasses.replace(state, it=torch.full((), start_it, dtype=torch.int32, device=dev))
    use_chamfer = frames[0].thinned is not None and o.lambda_deformed_node_prjection > 1e-8
    history = []
    best_psnr = -1.0
    ladder_pol = None
    if cfg.pipe.use_tile_ladder and cfg.pipe.rasterizer == "tiled":
        ladder_pol = LadderPolicy(n_buckets=cfg.pipe.ladder_buckets, margin=cfg.pipe.ladder_margin)
    densified_at = -1
    n_iters = o.iterations if o.iterations_stage2 is None else o.iterations_stage2
    prev = None  # (it, metrics) of the previous step: its overflow is read a step late

    def late_read(p_it, p_metrics, last=False):
        of_t, of_r = _overflow(p_metrics)[:2]
        if of_t or of_r:
            log(it=p_it, event="overflow", tiles=of_t, rect=of_r)
        if ladder_pol is not None and (last or ladder_pol.ladder is None or of_t > 0
                                       or p_it % cfg.pipe.ladder_check_every == 0 or p_it == densified_at + 1):
            old = ladder_pol.ladder
            ladder_pol.observe(p_metrics["tile_counts"].cpu().numpy(), of_t)
            if ladder_pol.ladder != old:
                log(it=p_it, event="ladder fit" if old is None else "ladder refit", ladder=ladder_pol.ladder,
                    refits=ladder_pol.refits)

    for it in range(start_it, n_iters):
        uid = sampler.sample(it, o.progressive_train, o.progressive_stage_ratio, o.progressive_stage_steps)
        frame = frames[uid]
        warm = it < o.skeleton_warm_up
        if it == o.optimize_template_offsets_iters:
            # the staged unlock: the control nodes restart from the alive Gaussians
            idx = farthest_point_sample(state.gs.xyz, cfg.model.skeleton_gs_sample_num, mask=state.gs.alive)
            state.skel.control_nodes = state.gs.xyz[idx.to(torch.int64)].detach()
            log(it=it, event="fps reset", idx=idx)
        state, metrics = step_auto(
            state, frame, uid, bg, info.d_xyz, info.d_joints, it=it, use_chamfer=use_chamfer,
            lambda_dssim=o.lambda_dssim, max_per_tile=cfg.pipe.max_per_tile, isotropic=cfg.model.use_isotropic_gs,
            tile_ladder=ladder_pol.ladder if ladder_pol is not None else None,
        )
        if prev is not None:
            late_read(*prev)
        prev = (it, metrics)
        if (not warm and o.gs_densification_iterations < it < o.densify_until_iter and it > o.densify_from_iter
                and it % o.densification_interval == 0):
            before = int(metrics["n_gs"])
            st = densify_step(TrainState(state.gs, state.opt_gs, state.stats_gs), draws.split_noise(state.gs.capacity),
                              o.densify_grad_threshold, scene.cameras_extent, percent_dense=o.percent_dense)
            state = dataclasses.replace(state, gs=st.gs, opt_gs=st.opt, stats_gs=st.stats)
            after = int(st.gs.num_alive)
            densified_at = it
            log(it=it, event="gs densify", before=before, after=after)
            if ladder_pol is not None and ladder_pol.ladder is not None:
                # ride ahead of the growth: one refit instead of overflow churn
                if before > 0 and after > before and ladder_pol.anticipate(after / before):
                    log(it=it, event="ladder anticipate", ladder=ladder_pol.ladder, refits=ladder_pol.refits)
        if log_every and it % log_every == 0:
            history.append((it, {k: float(v) for k, v in metrics.items() if v.dim() == 0}))
            if logger is not None:
                logger.scalars(it, "train_skeleton", history[-1][1])
        if test_every and it > 0 and it % test_every == 0 and scene.test_frames:
            means = evaluate_stage2(state, scene.test_frames, bg,
                                    tile_ladder=ladder_pol.ladder if ladder_pol is not None else None)
            log(it=it, event="test", **means)
            if logger is not None:
                logger.scalars(it, "test", means)
            if means.get("psnr", 0.0) > best_psnr and model_path is not None:
                from riggs_tpu_torch.io.checkpoint import save_checkpoint

                best_psnr = means["psnr"]
                save_checkpoint(model_path, it, state, gs=state.gs)
                log(it=it, event="checkpoint", psnr=best_psnr)
        if step_callback is not None:
            step_callback(state, it)
    if prev is not None:  # the last step's late read
        late_read(*prev, last=True)
    if ladder_pol is not None:
        log(it=n_iters, event="ladder", ladder=ladder_pol.ladder, refits=ladder_pol.refits)
    return state, info, history
