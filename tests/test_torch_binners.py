"""The compact and sort2 binners of riggs_tpu_torch against riggs_tpu on the
same numpy scenes: windows, counts and the structural by-products exactly;
the structural window-gather backwards against the reference's custom VJPs
and against autograd's own index backward; rasterize_tiled with either
binner, forward and gradients, against the reference's Pallas blend in
interpret mode; render_auto's compact escalation of max_instances (the
reference's CPU blend there: the escalation does not depend on it).

Tolerances: integer outputs exactly equal; the sort2 gather backward 1e-6
absolute (float32 sums over K in another order); the compact one 2e-5
absolute: it differences a float32 running sum over all slots (here of
magnitude ~40, so each difference carries rounding of ~1e-5, in another
association than XLA's scan); images and alpha 3e-5, depth 2e-4 (the
render tests' bounds); gradients 5e-5 absolute (the runs tests' bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.models import gaussians as JG
from riggs_tpu.render import api as JAPI
from riggs_tpu.render import binning as JB
from riggs_tpu.render.tiles import gather_grid as j_gather_grid, gather_instances as j_gather_instances
from riggs_tpu.render.tiles import rasterize_tiled as j_rasterize
from riggs_tpu_torch.convert import gaussians_from_numpy
from riggs_tpu_torch.render import api as TAPI
from riggs_tpu_torch.render import binning as TB
from riggs_tpu_torch.render.tiles import gather_grid, gather_instances, rasterize_tiled as t_rasterize
from tests.test_torch_render import _cams, _projected, _scene, _t

BINNERS = {
    "compact": (JB.bin_gaussians_compact, TB.bin_gaussians_compact),
    "sort2": (JB.bin_gaussians_sorted2, TB.bin_gaussians_sorted2),
}
CASES = {
    "compact": {"roomy": dict(max_per_tile=256), "budget_overflow": dict(max_per_tile=128, max_instances=200)},
    "sort2": {"roomy": dict(max_per_tile=256), "rect_overflow": dict(max_per_tile=128, max_tiles_per_gaussian=4)},
}


def _case_ids():
    return [(b, c) for b in CASES for c in CASES[b]]


def _bins(binner, kw, seed=0, n=300):
    rng = np.random.default_rng(seed)
    jp, tp, _ = _projected(rng, n, 96, 80, extent=0.5, log_scale=(-3.5, -1.5))
    jfn, tfn = BINNERS[binner]
    return jfn(jp, 96, 80, **kw), tfn(tp, 96, 80, **kw)


@pytest.mark.parametrize("binner,case", _case_ids())
def test_binner_matches(binner, case):
    jb, tb = _bins(binner, CASES[binner][case])
    for k in ("idx", "valid", "count", "overflow"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(), np.asarray(getattr(jb, k)), err_msg=k)
    info_j, info_t = (jb.compact, tb.compact) if binner == "compact" else (jb.grid, tb.grid)
    for k in info_j._fields:
        np.testing.assert_array_equal(getattr(info_t, k).numpy(), np.asarray(getattr(info_j, k)), err_msg=k)
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)
    assert (int(tb.overflow) > 0) == (case != "roomy") and int(tb.count.max()) > 8


def _gathers(binner, jb, tb, kw):
    if binner == "compact":
        return (lambda p: j_gather_instances(p, jb.idx, jb.compact)), (lambda p: gather_instances(p, tb.idx, tb.compact))
    side = int(np.ceil(np.sqrt(kw.get("max_tiles_per_gaussian", 16))))
    return (lambda p: j_gather_grid(p, jb.grid, side * side)), (lambda p: gather_grid(p, tb.grid, side * side))


@pytest.mark.parametrize("binner,case", _case_ids())
def test_structural_gather_backward_matches(binner, case):
    """The window gather and its structural backward against the
    reference's custom VJP on one cotangent, and (with the cotangent zero at
    the invalid slots, as the blend leaves it) against autograd's index
    backward of packed[idx]."""
    kw = CASES[binner][case]
    jb, tb = _bins(binner, kw)
    rng = np.random.default_rng(1)
    packed = rng.normal(size=(300, 10)).astype(np.float32)
    jfn, tfn = _gathers(binner, jb, tb, kw)
    cot = rng.normal(size=tuple(jb.idx.shape) + (10,)).astype(np.float32)
    cot *= np.asarray(jb.valid)[..., None]
    jg, jvjp = jax.vjp(jfn, jnp.asarray(packed))
    tp = torch.tensor(packed, requires_grad=True)
    tg = tfn(tp)
    np.testing.assert_array_equal(tg.detach().numpy(), np.asarray(jg))
    (g,) = torch.autograd.grad(tg, tp, torch.as_tensor(cot))
    atol = 2e-5 if binner == "compact" else 1e-6
    np.testing.assert_allclose(g.numpy(), np.asarray(jvjp(jnp.asarray(cot))[0]), rtol=0, atol=atol)
    if case == "roomy":  # with dropped instances the structural form differs by design
        tp2 = torch.tensor(packed, requires_grad=True)
        (plain,) = torch.autograd.grad(tp2[tb.idx.to(torch.int64)], tp2, torch.as_tensor(cot))
        np.testing.assert_allclose(g.numpy(), plain.numpy(), rtol=0, atol=atol)
        assert float(plain.abs().max()) > 1.0


def _scene_args(seed=8, n=300):
    rng = np.random.default_rng(seed)
    means, colors, opacity, scales, rots = _scene(rng, n, extent=0.4)
    scales[:3] *= 15.0  # a few splats over many tiles
    return means, colors, opacity, scales, rots, np.array([0.2, 0.1, 0.4], np.float32)


@pytest.mark.parametrize("binning", ["compact", "sort2"])
def test_rasterize_tiled_binners_match(binning):
    args = _scene_args()
    jc, tc = _cams(64, 64)
    kw = dict(binning=binning, max_per_tile=256)
    a = j_rasterize(jc, *(jnp.asarray(x) for x in args), blend="pallas", **kw)
    b = t_rasterize(tc, *_t(*args), **kw)
    np.testing.assert_allclose(b["image"].numpy(), np.asarray(a["image"]), atol=3e-5, rtol=0)
    np.testing.assert_allclose(b["alpha"].numpy(), np.asarray(a["alpha"]), atol=3e-5, rtol=0)
    np.testing.assert_allclose(b["depth"].numpy(), np.asarray(a["depth"]), atol=2e-4, rtol=0)
    for k in ("overflow", "overflow_tiles", "overflow_rect", "max_count", "tile_counts"):
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]), err_msg=k)
    assert int(b["max_count"]) > 128 and int(b["overflow"]) == 0
    # the same frame as the sort binner's
    c = t_rasterize(tc, *_t(*args), max_per_tile=256)
    np.testing.assert_allclose(b["image"].numpy(), c["image"].numpy(), atol=3e-5, rtol=0)


@pytest.mark.parametrize("binning", ["compact", "sort2"])
def test_rasterize_tiled_binner_grads_match(binning):
    """d(means, colours, opacity, scales) of a mean squared error through
    the structural gathers and blend_cm's backward."""
    means, colors, opacity, scales, rots, _ = _scene_args(seed=11, n=80)
    jc, tc = _cams(64, 64)
    target = 0.5

    def jloss(m, c, o, s):
        out = j_rasterize(jc, m, c, o, s, jnp.asarray(rots), jnp.zeros(3), binning=binning, blend="pallas",
                          max_per_tile=128)
        return jnp.mean((out["image"] - target) ** 2)

    ja = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (means, colors, opacity, scales)))
    m, c, o, s = (torch.tensor(x, requires_grad=True) for x in (means, colors, opacity, scales))
    out = t_rasterize(tc, m, c, o, s, *_t(rots), torch.zeros(3), binning=binning, max_per_tile=128)
    tg = torch.autograd.grad(torch.mean((out["image"] - target) ** 2), (m, c, o, s))
    for a, b, name in zip(ja, tg, ("means", "colors", "opacity", "scales")):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-5, rtol=0, err_msg=name)
        assert float(b.abs().max()) > 0, name


def _recorded_budgets(monkeypatch, module):
    calls = []
    orig = module.render

    def rec(*args, **kw):
        calls.append((kw["max_per_tile"], kw["max_tiles_per_gaussian"], kw["max_instances"]))
        return orig(*args, **kw)

    monkeypatch.setattr(module, "render", rec)
    return calls


def test_render_auto_compact_escalates_like_the_reference(monkeypatch):
    """render_auto(binning="compact") from a budget far below the instance
    count doubles max_instances on the rect counter, walks the reference's
    caps, and ends with the compact render at the default budget."""
    means, colors, opacity, scales, rots, _ = _scene_args(seed=12)
    jgs = JG.create_from_pcd(means, colors, capacity=320, max_sh_degree=0, with_motion_mask=False)
    jgs = dataclasses.replace(jgs, scaling=jnp.asarray(np.pad(np.log(scales), ((0, 20), (0, 0)), constant_values=-9.0)))
    tgs = gaussians_from_numpy(jax.tree.map(np.asarray, jgs.params_dict()), np.asarray(jgs.alive), 0,
                               with_motion_mask=False, device="cpu")
    jc, tc = _cams(64, 64)
    with torch.no_grad():
        full = TAPI.render(tc, tgs, torch.zeros(3), binning="compact")
    jcalls = _recorded_budgets(monkeypatch, JAPI)
    tcalls = _recorded_budgets(monkeypatch, TAPI)
    a = JAPI.render_auto(jc, jgs, jnp.zeros(3), binning="compact", max_instances=64)
    with torch.no_grad():
        b = TAPI.render_auto(tc, tgs, torch.zeros(3), binning="compact", max_instances=64)
    assert tcalls == jcalls and len(tcalls) > 2
    assert [c[1] for c in tcalls] == [16] * len(tcalls)  # no rect cap to raise
    assert int(b["overflow"]) == int(a["overflow"]) == 0
    np.testing.assert_allclose(b["render"].numpy(), np.asarray(a["render"]), atol=3e-5, rtol=0)
    np.testing.assert_array_equal(b["render"].numpy(), full["render"].numpy())
