"""No host reads on the port's training steps and frames (ROADMAP C2).

On the card, a host read of a device value (``.item()``, ``int()`` /
``bool()`` / ``float()`` of a tensor, indexing by a boolean mask or by a
0-dim tensor, ``nonzero``, ``torch.unique``, ``repeat_interleave`` without
``output_size``, a tensor made from host data) stops the host until the
stream drains. A ``TorchDispatchMode`` sees the aten operations behind each
of them on the CPU too, so these tests run every auto step and the serving
render under it (``HostReads``) and require none; the blend kernels' plain
versions, which stand in for the CUDA kernels on the CPU, are exempt.

Also here: ``extra_tier``'s ``handled`` mask, now an OR-scatter, against
riggs_tpu with the tier-handled splat in slot 0 and in slot N-1, with its
cap padded and full (C1's count kept); and the three auto steps taking
their learning rates from the caller's ``it``, not from ``state.it``.
"""
import dataclasses
import functools
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from riggs_tpu.render import binning as JB
from riggs_tpu_torch.camera import make_camera
from riggs_tpu_torch.data.dataset import Frame, SceneData
from riggs_tpu_torch.models import gaussians as TG
from riggs_tpu_torch.models import node_warp as TNW
from riggs_tpu_torch.models import skeleton_warp as TSW
from riggs_tpu_torch.render import binning as TB
from riggs_tpu_torch.render import blend as B
from riggs_tpu_torch.render.api import render
from riggs_tpu_torch.render.ladder import make_tile_ladder
from riggs_tpu_torch.render.project import Projected
from riggs_tpu_torch.train import stage1 as TS1
from riggs_tpu_torch.train import stage2 as TS2
from riggs_tpu_torch.train.config import Config
from riggs_tpu_torch.train.optim import adam_init

from tests.test_torch_render import _cams, _scene, _t, j_cov, j_project
from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)

aten = torch.ops.aten
_READS = {aten._local_scalar_dense.default: "a device value read on the host (.item(), int(), bool(), 0-dim index)",
          aten.nonzero.default: "nonzero", aten.masked_select.default: "masked_select",
          aten._unique2.default: "torch.unique", aten.unique_dim.default: "torch.unique",
          aten.unique_consecutive.default: "torch.unique_consecutive",
          aten.lift_fresh.default: "a tensor made from host data"}
_INDEX = (aten.index.Tensor, aten.index_put.default, aten.index_put_.default, aten._index_put_impl_.default)


class HostReads(TorchDispatchMode):
    """Records each aten operation that would read the card on the host."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        why = _READS.get(func)
        if func in _INDEX and any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                                  for i in args[1]):
            why = "indexing by a boolean mask (a nonzero)"
        if func is aten.repeat_interleave.Tensor and kwargs.get("output_size") is None:
            why = "repeat_interleave without output_size"
        if why is not None:
            self.hits.append((why, "".join(traceback.format_stack(limit=8)[:-2])))
        return func(*args, **kwargs)


def _unguarded(fn):
    @functools.wraps(fn)
    def run(*a, **k):
        with _disable_current_modes():
            return fn(*a, **k)
    return run


@pytest.fixture
def plain_blends_exempt(monkeypatch):
    """The blends' plain versions (the CPU stand-ins for the kernels) run
    outside the guard."""
    for name in ("blend_cm_plain", "blend_permuted_gm_plain", "blend_runs_plain", "blend_cm_bwd_plain",
                 "blend_permuted_gm_bwd_plain", "blend_runs_bwd_plain"):
        monkeypatch.setattr(B, name, _unguarded(getattr(B, name)))


def _guarded(fn):
    """Run ``fn`` once to fill the caches of constants, then under the
    guard; returns (its result, the reads seen)."""
    fn()
    with HostReads() as g:
        out = fn()
    return out, g.hits


def _assert_no_reads(hits, what):
    sites = sorted({f"{why} at\n{where}" for why, where in hits})
    assert not hits, f"{what}: {len(hits)} host read(s) at {len(sites)} site(s):\n" + "\n".join(sites)


@pytest.mark.parametrize("slot,cap", [(0, 8), (-1, 8), (0, 1), (-1, 1)],
                         ids=["slot0_padded", "last_padded", "slot0_full", "last_full"])
def test_extra_tier_handled_keeps_c1_count(slot, cap):
    """One large splat in slot 0 or N-1 and a mid tier of 8 slots (padded:
    the pad slots clear a real True at N-1, C1) or of 1 slot (full: nothing
    clears it); rect overflow and instances as riggs_tpu's, and no host read."""
    rng = np.random.default_rng(4)
    n = 40
    means, colors, opacity, scales, rots = _scene(rng, n, extent=0.5)
    scales[:] = 0.005
    scales[slot], means[slot] = 0.4, 0.0
    jc, _ = _cams(128, 128)
    jp = j_project(jc, jnp.asarray(means), j_cov(jnp.asarray(scales), jnp.asarray(rots)))
    tp = Projected(*_t(*jp))
    kw = dict(max_tiles_per_gaussian=4, mid_cap=cap, mid_side=4, giant_cap=0)
    jb = JB.bin_gaussians_sorted(jp, 128, 128, max_per_tile=256, **kw)
    tb, hits = _guarded(lambda: TB.bin_gaussians_sorted(tp, 128, 128, max_per_tile=256, **kw))
    _assert_no_reads(hits, "bin_gaussians_sorted")
    assert int(tb.overflow) == int(jb.overflow)
    assert (int(tb.overflow) > 0) == (slot == -1 and cap > 1)  # C1: only the padded tier loses slot N-1
    np.testing.assert_array_equal(tb.gid_sorted.numpy(), np.asarray(jb.gid_sorted))


SIZE = 32


def _frame(gs, cam):
    with torch.no_grad():
        out = render(cam, gs, torch.zeros(3), active_sh_degree=gs.max_sh_degree, max_per_tile=512)
    thinned = torch.zeros((16, 2))
    thinned[:8] = torch.rand(8, 2, generator=torch.Generator().manual_seed(0)) * SIZE
    return Frame(cam=dataclasses.replace(cam, fid=torch.tensor(0.4)), image=out["render"].clamp(0, 1) * 0.8,
                 alpha_mask=(out["alpha"] > 0.5).float(), thinned=thinned, thinned_mask=torch.arange(16) < 8)


@pytest.fixture(scope="module")
def stage1():
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(150, 3)) * [0.25, 0.4, 0.1]).astype(np.float32)
    cfg = Config()
    cfg.model.capacity, cfg.model.node_num, cfg.model.gs_with_motion_mask = 192, 24, True
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 2.0]), SIZE, SIZE, fovx=0.9, fovy=0.9, device="cpu")
    state = TS1.init_stage1(SceneData(pts, rng.uniform(size=(150, 3))), cfg,
                            generator=torch.Generator().manual_seed(0), device="cpu")
    return cfg, state, _frame(state.gs, cam)


@pytest.fixture(scope="module")
def stage2():
    rng = np.random.default_rng(5)
    joints = rng.normal(scale=0.3, size=(5, 3)).astype(np.float32)
    parents = (0, 0, 1, 1, 2)
    gs = TG.create_from_pcd(rng.normal(scale=0.3, size=(150, 3)), rng.uniform(size=(150, 3)), capacity=192,
                            max_sh_degree=1, device="cpu")
    skel = TSW.init_skeleton_warp(joints, parents, generator=torch.Generator().manual_seed(1), device="cpu")
    state = TS2.Stage2State(gs=gs, skel=skel, opt_gs=adam_init(gs.params_dict()), opt_skel=adam_init(skel.params_dict()),
                            stats_gs=TG.init_densify_stats(192, device="cpu"), proj_loss=torch.full((2,), 1e5),
                            it=torch.zeros((), dtype=torch.int32))
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 2.0]), SIZE, SIZE, fovx=0.9, fovy=0.9, device="cpu")
    cfg = Config()
    cfg.model.sh_degree, cfg.model.use_template_offsets, cfg.model.use_skinning_weight_mlp = 1, True, True
    return cfg, state, _frame(gs, cam), torch.zeros((2, 192, 3)), torch.zeros((2, 5, 3))


def _ladder(gs, cam):
    with torch.no_grad():
        counts = render(cam, gs, torch.zeros(3), max_per_tile=512)["tile_counts"].numpy()
    return make_tile_ladder(counts[None], n_buckets=2)


@pytest.mark.parametrize("it", [0, 7501])
def test_phase_a_auto_step_reads_nothing(stage1, plain_blends_exempt, it):
    cfg, state, fr = stage1
    step = TS1.make_phase_a_auto(cfg, 0.125)
    gen = torch.Generator().manual_seed(2)

    def run():
        reg_t = {"elastic": TNW.arap_sample_times(gen, t=fr.fid, delta_t=0.125, t_samp_num=8),
                 "acc": TNW.sample_time(gen, t=fr.fid, delta_t=0.375),
                 "arap": TNW.arap_sample_times(gen, device="cpu")}
        return step(state, fr, torch.zeros(3), reg_t, it=it, max_per_tile=512)

    _, hits = _guarded(run)
    _assert_no_reads(hits, f"make_phase_a_auto at it={it}")


@pytest.mark.parametrize("ladder", [False, True], ids=["plain", "ladder"])
def test_phase_b_auto_step_reads_nothing(stage1, plain_blends_exempt, ladder):
    cfg, state, fr = stage1
    step = TS1.make_phase_b_auto(cfg)
    tl = _ladder(state.gs, fr.cam) if ladder else None
    run = lambda: step(state, fr, torch.zeros(3), TNW.arap_sample_times(device="cpu"), it=5000, use_chamfer=True,
                       use_motion_loss=True, max_per_tile=512, tile_ladder=tl)
    _, hits = _guarded(run)
    _assert_no_reads(hits, f"make_phase_b_auto ({'ladder' if ladder else 'plain windows'})")


@pytest.mark.parametrize("ladder", [False, True], ids=["plain", "ladder"])
def test_stage2_auto_step_and_frame_read_only_the_overflow(stage2, plain_blends_exempt, ladder):
    """make_stage2_auto reads nothing; eval_image reads its two overflow
    counters (by design: it re-renders on overflow), render nothing."""
    cfg, state, fr, pdx, pdj = stage2
    step = TS2.make_stage2_auto(cfg, template_idx=0)
    tl = _ladder(state.gs, fr.cam) if ladder else None
    _, hits = _guarded(lambda: step(state, fr, 0, torch.zeros(3), pdx, pdj, it=15001, max_per_tile=512,
                                    tile_ladder=tl))
    _assert_no_reads(hits, "make_stage2_auto")
    _, hits = _guarded(lambda: TS2._eval_image(state.gs, state.skel, fr.cam, 0.3, torch.zeros(3), tile_ladder=tl))
    _assert_no_reads(hits, "_eval_image (skeleton_forward + render)")
    img, hits = _guarded(lambda: TS2.eval_image(state.gs, state.skel, fr.cam, 0.3, torch.zeros(3), tile_ladder=tl))
    assert [w for w, _ in hits] == [_READS[aten._local_scalar_dense.default]] * 2, hits
    assert img.shape == (SIZE, SIZE, 3)


def test_auto_steps_take_their_rates_from_the_callers_it(stage1, stage2, monkeypatch):
    """Each auto step derives its learning rates and flags from the ``it``
    it is given, whatever ``state.it`` holds, and still increments it."""
    cfg1, s1, fr1 = stage1
    cfg2, s2, fr2, pdx, pdj = stage2
    seen = {}

    def fake(name):
        def step(state, *a, **k):
            seen[name] = (a, k)
            return state, {}
        return step

    monkeypatch.setattr(TS1, "phase_a_step", fake("a"))
    monkeypatch.setattr(TS1, "phase_b_step", fake("b"))
    monkeypatch.setattr(TS2, "stage2_step", fake("s2"))
    gauss_lrs, warp_lrs = TS1.stage1_lr_fns_f32(cfg1)
    it = 3500  # state.it is 0: past every warm-up, inside the rate schedules
    new, _ = TS1.make_phase_a_auto(cfg1, 0.125)(s1, fr1, torch.zeros(3), {}, it=it)
    a, k = seen["a"]
    assert (a[2], a[3]) == (gauss_lrs(it), warp_lrs(it)) != (gauss_lrs(0), warp_lrs(0))
    assert k["detach_dxyz"] is False and k["use_reg"] is True and int(new.it) == int(s1.it) + 1 == 1
    new, _ = TS1.make_phase_b_auto(cfg1)(s1, fr1, torch.zeros(3), torch.zeros(2), it=it)
    a, k = seen["b"]
    assert (a[2], a[3]) == (gauss_lrs(it), warp_lrs(it))
    assert k["warm"] is False and k == {**k, **TS1.phase_b_flags(cfg1, it)} and int(new.it) == 1
    TS2.make_stage2_auto(cfg2, template_idx=0)(s2, fr2, 0, torch.zeros(3), pdx, pdj, it=it)
    a, k = seen["s2"]
    o = cfg2.opt
    from riggs_tpu_torch.train import schedule as S
    want_xyz = S.expon_lr_f32(o.position_lr_init, o.position_lr_final, lr_delay_mult=o.position_lr_delay_mult,
                              max_steps=o.position_lr_max_steps)(it)
    want_skel = S.expon_lr_f32(o.deform_mlp_lr_init, o.deform_mlp_lr_final, lr_delay_mult=o.deform_mlp_lr_delay_mult,
                               max_steps=o.deform_mlp_lr_max_steps)(it - o.skeleton_warm_up)
    assert a[3]["xyz"] == want_xyz and a[4] == want_skel and k["warm"] is False


def test_train_stage2_non_event_step_reads_only_the_late_overflow(stage1, plain_blends_exempt, monkeypatch):
    """One step of train_stage2 with no event (the ladder fitted, no check,
    densification, reset, log or test due): from the end of step 13 to the
    end of step 14 nothing reads the card but the one copy of step 13's two
    overflow counters."""
    cfg1, s1, fr = stage1
    frames = [dataclasses.replace(fr, cam=dataclasses.replace(fr.cam, fid=torch.tensor(t))) for t in (0.1, 0.5, 0.8)]
    scene = SceneData(np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32), train_frames=frames)
    cfg = Config()
    cfg.model.capacity, cfg.model.node_num, cfg.model.gs_with_motion_mask = 192, 24, True
    cfg.model.use_template_offsets = cfg.model.use_skinning_weight_mlp = True
    cfg.model.skeleton_gs_sample_num = 32
    cfg.pipe.max_per_tile = 512
    cfg.opt.iterations_stage2, cfg.opt.skeleton_warm_up, cfg.opt.optimize_template_offsets_iters = 15, 3, 6
    metrics, reads, window = [], [], {}
    real_auto, real_overflow = TS2.make_stage2_auto, TS2._overflow

    def auto(*a, **k):
        step = real_auto(*a, **k)

        def run(*sa, **sk):
            out = step(*sa, **sk)
            metrics.append(out[1])
            return out
        return run

    def overflow(m):
        reads.append(m)
        return real_overflow(m)

    def callback(state, it):
        if it == 13:
            window["guard"] = HostReads().__enter__()
            window["reads"] = len(reads)
        elif it == 14:
            window["guard"].__exit__(None, None, None)
            window["reads"] = reads[window["reads"]:]

    monkeypatch.setattr(TS2, "make_stage2_auto", auto)
    monkeypatch.setattr(TS2, "_overflow", overflow)
    events = []
    TS2.train_stage2(s1, scene, cfg, seed=1, events=events, step_callback=callback, device="cpu")
    assert [e["it"] for e in events if e["event"] == "ladder fit"] == [11]
    assert not [e for e in events if 12 <= e["it"] <= 14 and e["event"] != "ladder"], events
    _assert_no_reads(window["guard"].hits, "train_stage2 step 14")
    assert len(window["reads"]) == 1 and window["reads"][0] is metrics[13]
