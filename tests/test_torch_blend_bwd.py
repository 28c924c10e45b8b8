"""The port's blend backward (riggs_tpu_torch/render/blend.py) against the
reference's Pallas backward kernels in interpret mode (jax.vjp of
pallas_blend / pallas_blend_permuted_gm), and against torch autograd
through the plain forward, on the windows of tests/test_torch_blend.py.

On the CPU the autograd Functions run the plain backward versions; the CUDA
kernels are held against those versions on the card by chip_smoke.py.

Tolerance on dg: atol 1e-4, rtol 1e-3 (tests/test_pallas_blend.py:44), on
each attribute's gradients divided by their largest |reference| value: the
cotangents here are unit normals per pixel, so the conic gradients reach
~1e4 and their small elements are sums that cancel to ~1e-6 of the column.
Rows of skipped chunks, rows past the count and the channel-major padding
rows must be exactly 0: the window gathers send their gradients to real
Gaussians.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.render import pallas_blend as PB
from riggs_tpu_torch.render import blend as B

from tests.test_torch_blend import COUNTS, TILES_X, _saturate, _to_cm, _windows

TOL = dict(atol=1e-4, rtol=1e-3)
TIDS = np.array([3, 1, 0, 2], np.int32)


def _dout(seed, T=4):
    return np.random.default_rng(seed).normal(size=(T, 8, 1024)).astype(np.float32)


def _cm_case(seed=1):
    return _to_cm(_saturate(_windows(np.random.default_rng(seed), 4, 384), 0, 0))


def _gm_case(seed=2):
    return _saturate(_windows(np.random.default_rng(seed), 4, 384), 0, 3)


def _assert_dg(dg, ref, attr_axis):
    """assert_allclose per attribute, scaled by the attribute's largest |ref|."""
    axes = tuple(a for a in range(dg.ndim) if a != attr_axis % dg.ndim)
    scale = np.maximum(np.abs(ref).max(axis=axes, keepdims=True), 1e-30)
    np.testing.assert_allclose(dg / scale, ref / scale, **TOL)


def _port_cm_grad(g, dout):
    gt = torch.tensor(g, requires_grad=True)
    out, _ = B.blend_cm(gt, torch.as_tensor(COUNTS), TILES_X)
    (dg,) = torch.autograd.grad(out, gt, torch.as_tensor(dout))
    return dg.numpy()


def _port_gm_grad(g, dout):
    gt = torch.tensor(g, requires_grad=True)
    out, _ = B.blend_permuted_gm(gt, torch.as_tensor(COUNTS), torch.as_tensor(TIDS), TILES_X)
    (dg,) = torch.autograd.grad(out, gt, torch.as_tensor(dout))
    return dg.numpy()


def _assert_zero_rows_cm(dg):
    """Padding rows, chunks past the count and chunks entered saturated."""
    assert np.all(dg[:, 10:] == 0)
    for t, n in enumerate(COUNTS):
        first_skipped = -(-n // 128) * 128
        assert np.all(dg[t, :, first_skipped:] == 0), t
    assert np.all(dg[0, :, 128:] == 0)  # the saturated tile: chunks 1, 2 skipped


@pytest.mark.parametrize("seed", [0, 1])
def test_blend_cm_bwd_matches_pallas_interpret(seed):
    g, dout = _cm_case(), _dout(seed)
    _, vjp = jax.vjp(lambda x: PB.pallas_blend(x, jnp.asarray(COUNTS), TILES_X, True), jnp.asarray(g))
    (ref,) = vjp(jnp.asarray(dout))
    dg = _port_cm_grad(g, dout)
    _assert_dg(dg, np.asarray(ref), 1)
    _assert_zero_rows_cm(dg)
    assert np.abs(dg[:, :10]).max(axis=(0, 2)).min() > 0  # every attribute gets a gradient


@pytest.mark.parametrize("seed", [0, 1])
def test_blend_permuted_gm_bwd_matches_pallas_interpret(seed):
    g, dout = _gm_case(), _dout(seed)
    _, vjp = jax.vjp(
        lambda x: PB.pallas_blend_permuted_gm(x, jnp.asarray(COUNTS), jnp.asarray(TIDS), TILES_X, True),
        jnp.asarray(g),
    )
    (ref,) = vjp(jnp.asarray(dout))
    dg = _port_gm_grad(g, dout)
    _assert_dg(dg, np.asarray(ref), -1)
    for t, n in enumerate(COUNTS):
        assert np.all(dg[t, n:] == 0), t  # rows past the count
    assert np.all(dg[0, 128:] == 0)  # the saturated tile's skipped chunks
    assert np.abs(dg).max(axis=(0, 1)).min() > 0


def test_blend_bwd_plain_matches_autograd_of_plain_forward():
    """An independent check: torch autograd through _blend_plain."""
    dout = torch.as_tensor(_dout(5))
    g = torch.tensor(_cm_case(3), requires_grad=True)
    out, _ = B.blend_cm_plain(g, torch.as_tensor(COUNTS), TILES_X)
    (ref,) = torch.autograd.grad(out, g, dout)
    _assert_dg(_port_cm_grad(_cm_case(3), dout.numpy()), ref.numpy(), 1)
    g = torch.tensor(_gm_case(4), requires_grad=True)
    out, _ = B.blend_permuted_gm_plain(g, torch.as_tensor(COUNTS), torch.as_tensor(TIDS), TILES_X)
    (ref,) = torch.autograd.grad(out, g, dout)
    _assert_dg(_port_gm_grad(_gm_case(4), dout.numpy()), ref.numpy(), -1)


def test_blend_bwd_ignores_garbage_past_the_count():
    """Rows past the count (the ladder's invalid slots read row 0's
    Gaussian) change neither the gradient of the real rows nor their own 0."""
    g, dout = _gm_case(), _dout(0)
    g2 = g.copy()
    for t, n in enumerate(COUNTS):
        g2[t, n:, 5] = 0.99
        g2[t, n:, 6:10] = 1e3
    assert np.array_equal(_port_gm_grad(g, dout), _port_gm_grad(g2, dout))


def test_blend_function_takes_strided_dout_and_checks_inputs():
    """dout arrives strided from the untile transposes; the backward
    wrappers check shapes and types as the forward ones do."""
    g = torch.tensor(_cm_case(), requires_grad=True)
    counts = torch.as_tensor(COUNTS)
    out, tentry = B.blend_cm(g, counts, TILES_X)
    assert not tentry.requires_grad
    dout = torch.as_tensor(_dout(0)).transpose(1, 2).contiguous().transpose(1, 2)
    assert not dout.is_contiguous()
    B.reset_launches()
    (dg,) = torch.autograd.grad(out, g, dout)
    assert B.plain_bwd_calls["blend_cm_bwd"] == 1 and B.launches["blend_cm_bwd"] == 0
    np.testing.assert_array_equal(dg.numpy(), _port_cm_grad(_cm_case(), _dout(0)))
    with pytest.raises(ValueError):
        B.blend_cm_bwd(g.detach(), counts, tentry[:, :2], dout, TILES_X)
    with pytest.raises(ValueError):
        B.blend_cm_bwd(g.detach(), counts, tentry, dout.double(), TILES_X)
    with pytest.raises(ValueError):
        B.blend_permuted_gm_bwd(torch.zeros((4, 384, 10)), counts, torch.as_tensor(TIDS), tentry, dout[:, :5], TILES_X)


# Deep windows: 2 tiles x 10 chunks. Row 0 saturates in chunk SAT_CHUNK
# (faint splats before it, two staggered opaque layers on 4 px grids in it), so its
# later chunks are inactive and its earlier ones carry that chunk's suffix;
# row 1 stays live through all ten. Both counts end mid-chunk.
DEEP_CHUNKS, SAT_CHUNK = 10, 4
DEEP_COUNTS = np.array([1250, 1200], np.int32)
DEEP_TIDS = np.array([3, 1], np.int32)


def _deep_windows(seed, tiles):
    rng = np.random.default_rng(seed)
    T, n = len(tiles), DEEP_CHUNKS * 128
    g = np.zeros((T, n, 10), np.float32)
    ox = np.array([(t % TILES_X) * 32 for t in tiles], np.float32)[:, None]
    oy = np.array([(t // TILES_X) * 32 for t in tiles], np.float32)[:, None]
    g[..., 0] = ox + rng.uniform(-4, 36, (T, n))
    g[..., 1] = oy + rng.uniform(-4, 36, (T, n))
    a = 1.0 / rng.uniform(1.5, 4.0, (T, n)) ** 2
    g[..., 2] = a
    g[..., 3] = rng.uniform(-0.3, 0.3, (T, n)) * a
    g[..., 4] = a * rng.uniform(0.5, 1.5, (T, n))
    g[..., 5] = rng.uniform(0.01, 0.08, (T, n))
    g[..., 6:9] = rng.uniform(0, 1, (T, n, 3))
    g[..., 9] = rng.uniform(1, 5, (T, n))
    xs, ys = np.meshgrid(np.arange(0, 32, 4, dtype=np.float32), np.arange(0, 32, 4, dtype=np.float32))
    rows = slice(SAT_CHUNK * 128, (SAT_CHUNK + 1) * 128)
    g[0, rows, 0] = ox[0] + np.concatenate([xs.ravel(), xs.ravel() + 2])
    g[0, rows, 1] = oy[0] + np.concatenate([ys.ravel(), ys.ravel() + 2])
    g[0, rows, 2:5] = [1 / 49, 0.0, 1 / 49]
    g[0, rows, 5] = 0.98
    return g


def _deep_case(layout, seed=7):
    """(g in the layout's own shape, counts, tids); channel-major windows
    have their opacity masked past the count, as the caller does, and
    gaussian-major ones carry garbage there."""
    tids = np.arange(2, dtype=np.int32) if layout == "cm" else DEEP_TIDS
    g = _deep_windows(seed, tids)
    for t, n in enumerate(DEEP_COUNTS):
        if layout == "cm":
            g[t, n:, 5] = 0.0
        else:
            g[t, n:, 5:] = [0.99, 1e3, 1e3, 1e3, 1e3]
    return (_to_cm(g) if layout == "cm" else g), DEEP_COUNTS, tids


def _active(tentry, counts):
    """(T, C) active (tile, chunk) pairs: started, some pixel entering live."""
    c = np.arange(tentry.shape[1])
    return (c[None, :] * 128 < counts[:, None]) & (tentry.max(axis=2) >= B.T_EPS)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("layout", ["cm", "gm"])
def test_blend_bwd_matches_pallas_interpret_on_deep_windows(layout, seed):
    """The plain backward of both layouts against the Pallas backward in
    interpret mode on 2 tiles x 10 chunks, windows and dout from the seed:
    one tile saturating in chunk 4, counts ending mid-chunk; atol 1e-4, rtol
    1e-3 per attribute."""
    g, counts, tids = _deep_case(layout, seed)
    dout = _dout(seed, T=2)
    if layout == "cm":
        fn = lambda x: PB.pallas_blend(x, jnp.asarray(counts), TILES_X, True)
        port = lambda x: B.blend_cm(x, torch.as_tensor(counts), TILES_X)
    else:
        fn = lambda x: PB.pallas_blend_permuted_gm(x, jnp.asarray(counts), jnp.asarray(tids), TILES_X, True)
        port = lambda x: B.blend_permuted_gm(x, torch.as_tensor(counts), torch.as_tensor(tids), TILES_X)
    _, vjp = jax.vjp(fn, jnp.asarray(g))
    (ref,) = vjp(jnp.asarray(dout))
    gt = torch.tensor(g, requires_grad=True)
    out, tentry = port(gt)
    (dg,) = torch.autograd.grad(out, gt, torch.as_tensor(dout))
    dg, tentry = dg.numpy(), tentry.numpy()
    active = _active(tentry, counts)
    # the cases: row 0 live in chunk 4 and in none after it, row 1 through its count
    assert active[0].tolist() == [True] * (SAT_CHUNK + 1) + [False] * (DEEP_CHUNKS - SAT_CHUNK - 1)
    assert active[1].tolist() == [True] * DEEP_CHUNKS
    _assert_dg(dg, np.asarray(ref), 1 if layout == "cm" else -1)
    rows = np.repeat(~active, 128, axis=1)  # (T, MAX) rows of inactive chunks
    if layout == "cm":
        assert np.all(dg[:, 10:] == 0)
        assert np.all(dg.transpose(0, 2, 1)[rows] == 0)
    else:
        rows |= np.arange(DEEP_CHUNKS * 128)[None, :] >= counts[:, None]
        assert np.all(dg[rows] == 0)
    # chunks before the saturating one get a gradient through its suffix
    assert np.abs(dg[0, :, : SAT_CHUNK * 128] if layout == "cm" else dg[0, : SAT_CHUNK * 128]).max() > 0


def _chunk_terms(gt, c, a, px_all, py_all, counts, tentry, dC_all, mask_rows):
    """_blend_bwd_plain's per-chunk quantities for the active tiles ``a`` of
    chunk ``c``, op for op: everything the chunk needs from the forward's
    tentry alone."""
    row = torch.arange(B.G_CHUNK)
    g = gt[a, c * B.G_CHUNK : (c + 1) * B.G_CHUNK]
    mx, my = g[:, :, 0:1], g[:, :, 1:2]
    ca, cb, cc, op = g[:, :, 2:3], g[:, :, 3:4], g[:, :, 4:5], g[:, :, 5:6]
    dx = px_all[a][:, None, :] - mx
    dy = py_all[a][:, None, :] - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    raw = op * torch.exp(power)
    raw = torch.where(power > 0.0, 0.0, raw)
    alpha = torch.clamp(raw, max=B.ALPHA_MAX)
    alpha = torch.where(alpha < B.ALPHA_MIN, 0.0, alpha)
    ok = None
    if mask_rows:
        ok = ((c * B.G_CHUNK + row)[None, :] < counts[a][:, None])[:, :, None]
        alpha = torch.where(ok, alpha, 0.0)
        raw = torch.where(ok, raw, 0.0)
    cum = torch.cumsum(torch.log1p(-alpha), dim=1)
    t_in = tentry[:, c][a][:, None, :] * torch.exp(cum)
    inv_onem = 1.0 / (1.0 - alpha)
    te = t_in * inv_onem * (t_in >= B.T_EPS)
    w = alpha * te
    dC = dC_all[a]
    v = torch.cat([g[:, :, 6:10], torch.ones_like(op)], dim=2)
    vdc = torch.bmm(v, dC)
    s_incl = torch.cumsum(w * vdc, dim=1)
    return dict(g=g, dx=dx, dy=dy, ca=ca, cb=cb, cc=cc, op=op, power=power, raw=raw, ok=ok,
                inv_onem=inv_onem, te=te, w=w, dC=dC, vdc=vdc, s_incl=s_incl)


def _three_pass_bwd(gt, counts, tids, tiles_x, tentry, dout, mask_rows, runs):
    """The kernel's decomposition in plain torch: (i) each active chunk's
    s_total from tentry alone, (ii) each chunk's exclusive suffix, last
    chunk first, (iii) each active chunk's gradients from its own s_total
    and suffix. No chunk reads another's state but through (ii)."""
    T, MAX, _ = gt.shape
    C = MAX // B.G_CHUNK
    p = torch.arange(B.P_TILE)
    tids = tids.to(torch.int64)
    px_all = ((tids % tiles_x) * B.TILE)[:, None].add(p % B.TILE).to(torch.float32)
    py_all = ((tids // tiles_x) * B.TILE)[:, None].add(p // B.TILE).to(torch.float32)
    counts = counts.to(torch.int64)
    dC_all = dout[:, :5]
    actives = [torch.nonzero((c * B.G_CHUNK < counts) & (torch.amax(tentry[:, c], dim=1) >= B.T_EPS))[:, 0]
               for c in range(C)]
    total = torch.zeros((T, C, B.P_TILE))  # (i): zeros for inactive pairs
    for c, a in enumerate(actives):
        if a.numel():
            total[a, c] = _chunk_terms(gt, c, a, px_all, py_all, counts, tentry, dC_all, mask_rows)["s_incl"][:, -1]
    suffix = torch.zeros((T, C, B.P_TILE))  # (ii)
    run = torch.zeros((T, B.P_TILE))
    for c in range(C - 1, -1, -1):
        suffix[:, c] = run
        run = run + total[:, c]
    dgt = torch.zeros((T, MAX, B.ROWS_GM))  # (iii)
    for c, a in enumerate(actives):
        if not a.numel():
            continue
        k = _chunk_terms(gt, c, a, px_all, py_all, counts, tentry, dC_all, mask_rows)
        dx, dy, ca, cb, cc, op, raw, power = (k[n] for n in ("dx", "dy", "ca", "cb", "cc", "op", "raw", "power"))
        suf = (total[a, c][:, None, :] - k["s_incl"]) + suffix[a, c][:, None, :]
        dalpha = k["te"] * k["vdc"] - suf * k["inv_onem"]
        if runs:
            draw = dalpha * ((raw >= B.ALPHA_MIN) & (raw < B.ALPHA_MAX) & (power <= 0.0))
            dpower = draw * raw
            exppow = torch.where(power > 0.0, 0.0, torch.exp(power))
            d = torch.stack(
                [((ca * dx + cb * dy) * dpower).sum(-1), ((cc * dy + cb * dx) * dpower).sum(-1),
                 (-0.5 * dx * dx * dpower).sum(-1), (-dx * dy * dpower).sum(-1),
                 (-0.5 * dy * dy * dpower).sum(-1), (draw * exppow).sum(-1)], dim=-1,
            )
        else:
            dpower = dalpha * ((raw >= B.ALPHA_MIN) & (raw < B.ALPHA_MAX)) * raw
            dpx, dpy = dx * dpower, dy * dpower
            m_x, m_y = dpx.sum(-1), dpy.sum(-1)
            m_xx, m_xy, m_yy = (dx * dpx).sum(-1), (dy * dpx).sum(-1), (dy * dpy).sum(-1)
            m_p = dpower.sum(-1)
            ca, cb, cc, op = ca[..., 0], cb[..., 0], cc[..., 0], op[..., 0]
            d = torch.stack(
                [ca * m_x + cb * m_y, cc * m_y + cb * m_x, -0.5 * m_xx, -m_xy, -0.5 * m_yy,
                 m_p / torch.clamp(op, min=1e-12)], dim=-1,
            )
        d = torch.cat([d, torch.bmm(k["w"], k["dC"][:, :4].transpose(1, 2))], dim=-1)
        if k["ok"] is not None:
            d = torch.where(k["ok"], d, 0.0)
        dgt[a, c * B.G_CHUNK : (c + 1) * B.G_CHUNK] = d
    return dgt


@pytest.mark.parametrize("mask_rows,runs", [(False, False), (True, False), (False, True)],
                         ids=["cm", "gm", "runs"])
def test_three_pass_decomposition_gives_plain_bwd_bitwise(mask_rows, runs):
    """The (tile, chunk)-parallel decomposition the CUDA backward rests on,
    in plain torch on the CPU, gives _blend_bwd_plain's dg exactly (same
    operations on the same shapes): a chunk needs nothing of another chunk
    but the suffix of their s_total sums."""
    g, counts, tids = _deep_case("gm" if mask_rows else "cm")
    if not mask_rows:  # the channel-major windows (opacity masked past the count), gaussian-major
        g = np.ascontiguousarray(g[:, :10].transpose(0, 2, 1))
    gt, counts, tids = torch.as_tensor(g), torch.as_tensor(counts), torch.as_tensor(tids)
    _, tentry = B._blend_plain(gt, counts, tids, TILES_X, mask_rows)
    dout = torch.as_tensor(_dout(3, T=2))
    ref = B._blend_bwd_plain(gt, counts, tids, TILES_X, tentry, dout, mask_rows, runs)
    dg = _three_pass_bwd(gt, counts, tids, TILES_X, tentry, dout, mask_rows, runs)
    assert torch.equal(dg.view(torch.int32), ref.view(torch.int32))
    assert bool(ref[0, : SAT_CHUNK * 128].any()) and not bool(ref[0, (SAT_CHUNK + 1) * 128 :].any())


@pytest.mark.parametrize("variant", ["no-cut", "gm-256", "all-512"])
def test_bwd_variant_substitutions_match_the_source_once(variant):
    """scripts/torch_bwd_variants.py builds its variants of csrc/blend.cu by
    exact text substitution: each must match the shipped source once, and
    the variant must differ from it."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "torch_bwd_variants.py"
    spec = importlib.util.spec_from_file_location("torch_bwd_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = B.CSRC.read_text()
    text = src
    for old, new in mod.VARIANTS[variant]:
        assert src.count(old) == 1
        text = text.replace(old, new)
    assert text != src
