"""Fused per-tile front-to-back blend: the forward kernels and their backward.

Port of the blend kernels of ``riggs_tpu/render/pallas_blend.py``:

  * ``blend_cm`` replaces ``_fwd_kernel`` (entry ``pallas_blend``): windows
    arrive channel-major, g (T, 16, MAX), opacity already masked by the
    caller; with a ``tile_offset`` it is the entry ``pallas_blend_offset``
    of the same kernels, local tile t rendering the image's tile
    t + tile_offset: ``sharded_blend`` splits the tiles over a mesh's tile
    group that way;
  * ``blend_permuted_gm`` replaces ``_fwd_kernel_gm`` with ``permuted=True``
    (entry ``pallas_blend_permuted_gm``): windows arrive gaussian-major,
    g (T, MAX, 10), rows past the tile's count are masked inside the kernel,
    and row t renders the real tile ``tids[t]``;
  * ``blend_runs`` replaces ``_fwd_kernel_runs`` (entry
    ``pallas_blend_runs``): one channel-major aligned-runs array g_runs
    (16, M2), chunk c of tile t reading the 128-slot block ``runs_blocks``
    gives it (the run's block ``sblk[t] + c`` while the chunk starts before
    the count, else the spare last block, clamped to it); slots past a
    tile's count are zero rows.

Attribute rows: 0 mx, 1 my, 2..4 conic (a, b, c), 5 opacity, 6..8 rgb,
9 depth. Outputs: ``out`` (T, 8, 1024) rows [r, g, b, depth, acc, 0, 0, 0]
and ``tentry`` (T, C, 1024), the transmittance at entry to each 128-Gaussian
chunk (written for every chunk, skipped ones too). Per pixel and chunk:

  alpha = min(op * exp(power), 0.99), zeroed when power > 0 or alpha < 1/255
  t_in  = T_entry * exp(inclusive cumsum log1p(-alpha))   (after the Gaussian)
  w     = alpha * t_in / (1 - alpha) * [t_in >= 1e-4]
  out  += [rgb, depth, 1] * w

A chunk is skipped when it starts past the tile's count or when no pixel of
the tile has T_entry >= 1e-4.

A forward call is a memset of a small chain state and two device launches:
one block per (tile, chunk) pair, each passing its tile's entry T to the
next chunk as soon as it has it (a chunk whose entry T is not published yet
sums its log-sum ``cum`` first, then waits), its weighted sums into a
scratch; then one thread per (tile, pixel) adds those sums in chunk order
into ``out``. tentry has the bits of a sequential walk; ``out`` those of
per-chunk sums added in chunk order.

Each entry is a ``torch.autograd.Function`` (``BlendFn``): the forward
kernel, then, for the gradient, the backward kernel that replaces
``_bwd_kernel`` / ``_bwd_kernel_gm`` / ``_bwd_kernel_runs``
(``blend_cm_bwd``, ``blend_permuted_gm_bwd``, ``blend_runs_bwd``). A
backward call is three device launches, each over every (tile, chunk) pair
or every (tile, pixel): each chunk's per-pixel s_total into a scratch, the
suffix of the later chunks' sums, then each chunk's gradients from the two.
It writes d(mx, my, conic, opacity, rgb, depth) for every window row, exactly 0
for rows of skipped chunks, rows past the count and the channel-major
padding rows. Only the first are needed (their true gradient); the window
gathers' backward zeroes invalid slots, so the others are defensive: dg
equals its plain version element for element. The runs backward follows
``_bwd_body_runs``'s own formulas (the six geometric sums taken directly,
d_op = sum draw * exp(power)); its dg is zero but in the blocks of the
active (tile, chunk) pairs, and the spare block stays zero.

Each kernel is CUDA C++ (``riggs_tpu_torch/csrc/blend.cu``), built at first
use with nvcc for sm_90a into ``.torch_ext/`` beside the package and called
through ctypes. Beside each kernel sits its plain PyTorch version, a
vectorised (T, G, P) chunk loop of the same math; the wrappers use it for
CPU tensors only. On a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from riggs_tpu_torch import cuda_build, trace

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
G_CHUNK = 128
PACK_ROWS = 16  # channel-major rows: 10 used, padded
ROWS_GM = 10  # gaussian-major columns
OUT_ROWS = 8  # 5 used
TILE = 32
P_TILE = TILE * TILE

CSRC = cuda_build.CSRC_DIR / "blend.cu"
LIB_STEM = "libriggs_blend"

# launches of each kernel since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else
# (sharded_blend's calls, pallas_blend_offset's, count as blend_cm_offset and
# blend_cm_offset_bwd)
launches = {"blend_cm": 0, "blend_permuted_gm": 0, "blend_runs": 0,
            "blend_cm_bwd": 0, "blend_permuted_gm_bwd": 0, "blend_runs_bwd": 0,
            "blend_cm_offset": 0, "blend_cm_offset_bwd": 0}
# calls of the backward wrappers that ran the plain version (CPU tensors)
plain_bwd_calls = {"blend_cm_bwd": 0, "blend_permuted_gm_bwd": 0, "blend_runs_bwd": 0, "blend_cm_offset_bwd": 0}


def reset_launches() -> None:
    for d in (launches, plain_bwd_calls):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _blend_plain(gt: torch.Tensor, counts: torch.Tensor, tids: torch.Tensor, tiles_x: int, mask_rows: bool):
    """gt: (T, MAX, 10) gaussian-major rows; returns (out, tentry)."""
    T, MAX, _ = gt.shape
    C = MAX // G_CHUNK
    dev = gt.device
    p = torch.arange(P_TILE, device=dev)
    tids = tids.to(torch.int64)
    px = ((tids % tiles_x) * TILE)[:, None].add(p % TILE).to(torch.float32)[:, None, :]  # (T, 1, P)
    py = ((tids // tiles_x) * TILE)[:, None].add(p // TILE).to(torch.float32)[:, None, :]
    counts = counts.to(torch.int64)
    row = torch.arange(G_CHUNK, device=dev)

    out = torch.zeros((T, OUT_ROWS, P_TILE), dtype=torch.float32, device=dev)
    tentry = torch.empty((T, C, P_TILE), dtype=torch.float32, device=dev)
    trun = torch.ones((T, P_TILE), dtype=torch.float32, device=dev)
    for c in range(C):
        t_entry = trun
        tentry[:, c] = t_entry
        active = (c * G_CHUNK < counts) & (torch.amax(t_entry, dim=1) >= T_EPS)  # (T,)
        if not bool(active.any()):
            continue
        g = gt[:, c * G_CHUNK : (c + 1) * G_CHUNK]  # (T, G, 10)
        mx, my = g[:, :, 0:1], g[:, :, 1:2]
        ca, cb, cc, op = g[:, :, 2:3], g[:, :, 3:4], g[:, :, 4:5], g[:, :, 5:6]
        dx = px - mx  # (T, G, P)
        dy = py - my
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        raw = op * torch.exp(power)
        raw = torch.where(power > 0.0, 0.0, raw)
        alpha = torch.clamp(raw, max=ALPHA_MAX)
        alpha = torch.where(alpha < ALPHA_MIN, 0.0, alpha)
        keep = active[:, None]
        if mask_rows:
            keep = keep & ((c * G_CHUNK + row)[None, :] < counts[:, None])
        alpha = torch.where(keep[:, :, None], alpha, 0.0)
        lg = torch.log1p(-alpha)
        cum = torch.cumsum(lg, dim=1)  # sequential along the chunk, as the kernel sums
        t_in = t_entry[:, None, :] * torch.exp(cum)
        w = alpha * (t_in / (1.0 - alpha)) * (t_in >= T_EPS)
        v = torch.cat([g[:, :, 6:10], torch.ones_like(op)], dim=2)  # (T, G, 5)
        out[:, :5] += torch.bmm(v.transpose(1, 2), w)
        trun = t_entry * torch.exp(cum[:, -1])
    return out, tentry


def blend_cm_plain(g: torch.Tensor, counts: torch.Tensor, tiles_x: int, tile_offset: int = 0):
    """Plain version of ``blend_cm``: g (T, 16, MAX), counts (T,); local
    tile t renders tile t + tile_offset."""
    T = g.shape[0]
    tids = torch.arange(T, device=g.device) + tile_offset
    return _blend_plain(g[:, :ROWS_GM, :].transpose(1, 2), counts, tids, tiles_x, mask_rows=False)


def blend_permuted_gm_plain(g: torch.Tensor, counts: torch.Tensor, tids: torch.Tensor, tiles_x: int):
    """Plain version of ``blend_permuted_gm``: g (T, MAX, 10), counts/tids (T,)."""
    return _blend_plain(g, counts, tids, tiles_x, mask_rows=True)


def _blend_bwd_plain(gt, counts, tids, tiles_x: int, tentry, dout, mask_rows: bool, runs: bool = False):
    """Backward of ``_blend_plain`` (``_bwd_body`` / ``_bwd_body_gm``'s math,
    or with ``runs`` ``_bwd_body_runs``'s): gt (T, MAX, 10), tentry
    (T, C, P), dout (T, 8, P) -> dgt (T, MAX, 10). Chunks run back to
    front, each vectorised over (active tiles, G, P)."""
    T, MAX, _ = gt.shape
    C = MAX // G_CHUNK
    dev = gt.device
    p = torch.arange(P_TILE, device=dev)
    tids = tids.to(torch.int64)
    px_all = ((tids % tiles_x) * TILE)[:, None].add(p % TILE).to(torch.float32)  # (T, P)
    py_all = ((tids // tiles_x) * TILE)[:, None].add(p // TILE).to(torch.float32)
    counts = counts.to(torch.int64)
    row = torch.arange(G_CHUNK, device=dev)
    dC_all = dout[:, :5]  # [rgb, depth, acc] cotangents; rows 5..7 meet zero values

    dgt = torch.zeros((T, MAX, ROWS_GM), dtype=torch.float32, device=dev)
    suffix = torch.zeros((T, P_TILE), dtype=torch.float32, device=dev)
    for c in range(C - 1, -1, -1):
        t_entry = tentry[:, c]
        active = (c * G_CHUNK < counts) & (torch.amax(t_entry, dim=1) >= T_EPS)
        a = torch.nonzero(active)[:, 0]
        if a.numel() == 0:
            continue
        g = gt[a, c * G_CHUNK : (c + 1) * G_CHUNK]  # (A, G, 10)
        mx, my = g[:, :, 0:1], g[:, :, 1:2]
        ca, cb, cc, op = g[:, :, 2:3], g[:, :, 3:4], g[:, :, 4:5], g[:, :, 5:6]
        dx = px_all[a][:, None, :] - mx  # (A, G, P)
        dy = py_all[a][:, None, :] - my
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        raw = op * torch.exp(power)
        raw = torch.where(power > 0.0, 0.0, raw)
        alpha = torch.clamp(raw, max=ALPHA_MAX)
        alpha = torch.where(alpha < ALPHA_MIN, 0.0, alpha)
        ok = None
        if mask_rows:
            ok = ((c * G_CHUNK + row)[None, :] < counts[a][:, None])[:, :, None]  # (A, G, 1)
            alpha = torch.where(ok, alpha, 0.0)
            raw = torch.where(ok, raw, 0.0)
        cum = torch.cumsum(torch.log1p(-alpha), dim=1)
        t_in = t_entry[a][:, None, :] * torch.exp(cum)
        inv_onem = 1.0 / (1.0 - alpha)
        te = t_in * inv_onem * (t_in >= T_EPS)
        w = alpha * te
        dC = dC_all[a]  # (A, 5, P)
        v = torch.cat([g[:, :, 6:10], torch.ones_like(op)], dim=2)  # (A, G, 5)
        vdc = torch.bmm(v, dC)  # (A, G, P)
        s_incl = torch.cumsum(w * vdc, dim=1)
        s_total = s_incl[:, -1:, :]
        suf = (s_total - s_incl) + suffix[a][:, None, :]
        dalpha = te * vdc - suf * inv_onem
        if runs:
            draw = dalpha * ((raw >= ALPHA_MIN) & (raw < ALPHA_MAX) & (power <= 0.0))
            dpower = draw * raw
            exppow = torch.where(power > 0.0, 0.0, torch.exp(power))
            d = torch.stack(
                [((ca * dx + cb * dy) * dpower).sum(-1), ((cc * dy + cb * dx) * dpower).sum(-1),
                 (-0.5 * dx * dx * dpower).sum(-1), (-dx * dy * dpower).sum(-1),
                 (-0.5 * dy * dy * dpower).sum(-1), (draw * exppow).sum(-1)], dim=-1,
            )
        else:
            dpower = dalpha * ((raw >= ALPHA_MIN) & (raw < ALPHA_MAX)) * raw
            dpx = dx * dpower
            dpy = dy * dpower
            m_x, m_y = dpx.sum(-1), dpy.sum(-1)  # (A, G)
            m_xx, m_xy, m_yy = (dx * dpx).sum(-1), (dy * dpx).sum(-1), (dy * dpy).sum(-1)
            m_p = dpower.sum(-1)
            ca, cb, cc, op = ca[..., 0], cb[..., 0], cc[..., 0], op[..., 0]
            d = torch.stack(
                [ca * m_x + cb * m_y, cc * m_y + cb * m_x, -0.5 * m_xx, -m_xy, -0.5 * m_yy,
                 m_p / torch.clamp(op, min=1e-12)], dim=-1,
            )
        dv = torch.bmm(w, dC[:, :4].transpose(1, 2))  # (A, G, 4)
        d = torch.cat([d, dv], dim=-1)
        if ok is not None:
            d = torch.where(ok, d, 0.0)
        dgt[a, c * G_CHUNK : (c + 1) * G_CHUNK] = d
        suffix[a] = suffix[a] + s_total[:, 0]
    return dgt


def blend_cm_bwd_plain(g, counts, tentry, dout, tiles_x: int, tile_offset: int = 0):
    """Plain version of ``blend_cm_bwd``: dg (T, 16, MAX), padding rows 0."""
    T = g.shape[0]
    tids = torch.arange(T, device=g.device) + tile_offset
    dgt = _blend_bwd_plain(g[:, :ROWS_GM, :].transpose(1, 2), counts, tids, tiles_x, tentry, dout, mask_rows=False)
    dg = torch.zeros_like(g)
    dg[:, :ROWS_GM] = dgt.transpose(1, 2)
    return dg


def blend_permuted_gm_bwd_plain(g, counts, tids, tentry, dout, tiles_x: int):
    """Plain version of ``blend_permuted_gm_bwd``: dg (T, MAX, 10)."""
    return _blend_bwd_plain(g, counts, tids, tiles_x, tentry, dout, mask_rows=True)


def runs_blocks(counts: torch.Tensor, sblk: torch.Tensor, chunks: int, m2b: int) -> torch.Tensor:
    """(T, chunks) block of g_runs that chunk c of tile t reads
    (``pallas_blend.py:_runs_gidx``): ``sblk[t] + c`` while the chunk starts
    before the count, else the spare block m2b - 1; clamped to it, so an
    instance-budget overflow never reads past the array."""
    c = torch.arange(chunks, device=counts.device)[None, :]
    nblk = ((counts.to(torch.int64) + G_CHUNK - 1) // G_CHUNK)[:, None]
    return torch.clamp(torch.where(c < nblk, sblk.to(torch.int64)[:, None] + c, m2b - 1), max=m2b - 1)


def _runs_windows(g_runs: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """(T, chunks * 128, 10) gaussian-major windows of the blocks ``blk``."""
    T, C = blk.shape
    slots = (blk[:, :, None] * G_CHUNK + torch.arange(G_CHUNK, device=blk.device)).reshape(T, C * G_CHUNK)
    return g_runs[:ROWS_GM].t()[slots]


def blend_runs_plain(g_runs: torch.Tensor, counts: torch.Tensor, sblk: torch.Tensor, chunks: int, tiles_x: int):
    """Plain version of ``blend_runs``: g_runs (16, M2), counts/sblk (T,)."""
    blk = runs_blocks(counts, sblk, chunks, g_runs.shape[1] // G_CHUNK)
    tids = torch.arange(counts.shape[0], device=g_runs.device)
    return _blend_plain(_runs_windows(g_runs, blk), counts, tids, tiles_x, mask_rows=False)


def blend_runs_bwd_plain(g_runs, counts, sblk, tentry, dout, tiles_x: int):
    """Plain version of ``blend_runs_bwd``: dg (16, M2), the blocks of the
    active (tile, chunk) pairs written, every other slot 0. A pair whose
    block resolves to the spare block (only past an instance-budget
    overflow) writes nothing."""
    m2b = g_runs.shape[1] // G_CHUNK
    blk = runs_blocks(counts, sblk, tentry.shape[1], m2b)
    tids = torch.arange(counts.shape[0], device=g_runs.device)
    dgt = _blend_bwd_plain(_runs_windows(g_runs, blk), counts, tids, tiles_x, tentry, dout,
                           mask_rows=False, runs=True)
    own = blk < m2b - 1  # the run's own blocks: each belongs to one (tile, chunk)
    dg_blocks = torch.zeros((m2b, G_CHUNK, ROWS_GM), dtype=torch.float32, device=g_runs.device)
    dg_blocks[blk[own]] = dgt.reshape(*blk.shape, G_CHUNK, ROWS_GM)[own]
    dg = torch.zeros_like(g_runs)
    dg[:ROWS_GM] = dg_blocks.reshape(-1, ROWS_GM).t()
    return dg


# ---------------------------------------------------------------------------
# the kernels: build, load, launch
# ---------------------------------------------------------------------------


def _lib_path() -> Path:
    return cuda_build.lib_path(CSRC, LIB_STEM)


def build_log() -> str:
    """ptxas's report (registers, shared memory, spills per kernel) of the
    build ``load_library`` made or found."""
    return _lib_path().with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build ``csrc/blend.cu`` for sm_90a (once per source version) and load it."""
    return bind(cuda_build.load(CSRC, LIB_STEM))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries' argument and result types on a loaded build."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.riggs_blend_fwd_cm.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.riggs_blend_fwd_cm.restype = ci
    lib.riggs_blend_fwd_gm_permuted.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.riggs_blend_fwd_gm_permuted.restype = ci
    lib.riggs_blend_bwd_cm.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.riggs_blend_bwd_cm.restype = ci
    lib.riggs_blend_bwd_gm_permuted.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.riggs_blend_bwd_gm_permuted.restype = ci
    lib.riggs_blend_fwd_runs.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.riggs_blend_fwd_runs.restype = ci
    lib.riggs_blend_bwd_runs.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.riggs_blend_bwd_runs.restype = ci
    return lib


def _check(g: torch.Tensor, counts: torch.Tensor, tids: torch.Tensor | None, max_axis: int, rows: int, rows_axis: int):
    if g.dtype != torch.float32 or g.dim() != 3 or g.shape[rows_axis] != rows:
        raise ValueError(f"g must be float32 with {rows} rows on axis {rows_axis}, got {g.dtype} {tuple(g.shape)}")
    if g.shape[max_axis] % G_CHUNK != 0:
        raise ValueError(f"window length {g.shape[max_axis]} is not a multiple of {G_CHUNK}")
    for name, a in (("counts", counts), ("tids", tids)):
        if a is None:
            continue
        if a.dtype != torch.int32 or a.shape != (g.shape[0],):
            raise ValueError(f"{name} must be int32 of shape ({g.shape[0]},), got {a.dtype} {tuple(a.shape)}")
        if a.device != g.device:
            raise ValueError(f"{name} is on {a.device}, g on {g.device}")
    if g.device.type == "cuda":
        if not (g.is_contiguous() and counts.is_contiguous() and (tids is None or tids.is_contiguous())):
            raise ValueError("the blend kernels take contiguous tensors")
    elif g.device.type != "cpu":
        raise ValueError(f"unsupported device {g.device}")


def _outputs(g: torch.Tensor, T: int, C: int):
    """(out, tentry) for a forward call; out is zero where no launch writes
    it (T == 0 or C == 0)."""
    out = (torch.empty if T and C else torch.zeros)((T, OUT_ROWS, P_TILE), dtype=torch.float32, device=g.device)
    tentry = torch.empty((T, C, P_TILE), dtype=torch.float32, device=g.device)
    return out, tentry


FWD_SUMS = 5  # per-pixel sums of an active chunk: rgb, depth, acc


def fwd_scratch_bytes(T: int, C: int) -> int:
    """Bytes of the forward's scratch: (T, C, 5, 1024) f32 per-chunk sums
    (only the active chunks' are written and read), then the int32 chain
    state (a ticket, a flag per (tile, chunk), a flag per tile; zeroed by
    the kernel's C entry) and a count of active chunks per tile."""
    return (T * C * FWD_SUMS * P_TILE + 1 + T * C + 2 * T) * 4 if T and C else 0


def _fwd_scratch(g: torch.Tensor, T: int, C: int) -> torch.Tensor:
    return torch.empty(fwd_scratch_bytes(T, C) // 4, dtype=torch.float32, device=g.device)


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check_bwd(g: torch.Tensor, tentry: torch.Tensor, dout: torch.Tensor, T: int, C: int):
    for name, a, shape in (("tentry", tentry, (T, C, P_TILE)), ("dout", dout, (T, OUT_ROWS, P_TILE))):
        if a.dtype != torch.float32 or tuple(a.shape) != shape or a.device != g.device:
            raise ValueError(f"{name} must be float32 {shape} on {g.device}, got {a.dtype} {tuple(a.shape)} on {a.device}")
        if g.device.type == "cuda" and not a.is_contiguous():
            raise ValueError("the blend kernels take contiguous tensors")


def _bwd_scratch(g: torch.Tensor, T: int, C: int) -> torch.Tensor:
    """The backward's scratch (2, T, C, 1024): per (tile, chunk, pixel)
    s_total, then the suffix of the later chunks (written by the kernels;
    the entries of chunks past the count are never read)."""
    return torch.empty((2, T, C, P_TILE), dtype=torch.float32, device=g.device)


def blend_cm_fwd(g: torch.Tensor, counts: torch.Tensor, tiles_x: int, tile_offset: int = 0,
                 counter: str = "blend_cm"):
    """Channel-major blend of plain windows, no gradient: the kernel on CUDA,
    the plain version on the CPU. Local tile t renders the image's tile
    t + tile_offset; a launch counts under ``counter``. Returns (out,
    tentry)."""
    _check(g, counts, None, max_axis=2, rows=PACK_ROWS, rows_axis=1)
    if g.device.type == "cpu":
        return blend_cm_plain(g, counts, tiles_x, tile_offset)
    T, _, MAX = g.shape
    C = MAX // G_CHUNK
    out, tentry = _outputs(g, T, C)
    if T == 0 or C == 0:
        return out, tentry
    scratch = _fwd_scratch(g, T, C)
    lib = load_library()
    with torch.cuda.device(g.device):
        err = lib.riggs_blend_fwd_cm(
            g.data_ptr(), counts.data_ptr(), out.data_ptr(), tentry.data_ptr(), scratch.data_ptr(),
            T, C, tiles_x, int(tile_offset), torch.cuda.current_stream(g.device).cuda_stream,
        )
    _raise_on(err, counter)
    launches[counter] += 1
    return out, tentry


def blend_permuted_gm_fwd(g: torch.Tensor, counts: torch.Tensor, tids: torch.Tensor, tiles_x: int):
    """Gaussian-major blend of laddered windows, no gradient: the kernel on
    CUDA, the plain version on the CPU. Returns (out, tentry)."""
    _check(g, counts, tids, max_axis=1, rows=ROWS_GM, rows_axis=2)
    if g.device.type == "cpu":
        return blend_permuted_gm_plain(g, counts, tids, tiles_x)
    T, MAX, _ = g.shape
    C = MAX // G_CHUNK
    out, tentry = _outputs(g, T, C)
    if T == 0 or C == 0:
        return out, tentry
    scratch = _fwd_scratch(g, T, C)
    lib = load_library()
    with torch.cuda.device(g.device):
        err = lib.riggs_blend_fwd_gm_permuted(
            g.data_ptr(), counts.data_ptr(), tids.data_ptr(), out.data_ptr(), tentry.data_ptr(), scratch.data_ptr(),
            T, C, tiles_x, torch.cuda.current_stream(g.device).cuda_stream,
        )
    _raise_on(err, "blend_permuted_gm")
    launches["blend_permuted_gm"] += 1
    return out, tentry


def blend_cm_bwd(g: torch.Tensor, counts: torch.Tensor, tentry: torch.Tensor, dout: torch.Tensor, tiles_x: int,
                 tile_offset: int = 0, counter: str = "blend_cm_bwd"):
    """dL/dg (T, 16, MAX) of ``blend_cm_fwd`` (at the same ``tile_offset``)
    from the forward's tentry and dL/dout: the kernel on CUDA, the plain
    version on the CPU; a launch, or a plain call, counts under
    ``counter``."""
    _check(g, counts, None, max_axis=2, rows=PACK_ROWS, rows_axis=1)
    _check_bwd(g, tentry, dout, g.shape[0], g.shape[2] // G_CHUNK)
    if g.device.type == "cpu":
        plain_bwd_calls[counter] += 1
        return blend_cm_bwd_plain(g, counts, tentry, dout, tiles_x, tile_offset)
    T, _, MAX = g.shape
    dg = torch.empty_like(g)
    if T == 0 or MAX == 0:
        return dg
    scratch = _bwd_scratch(g, T, MAX // G_CHUNK)
    lib = load_library()
    with torch.cuda.device(g.device):
        err = lib.riggs_blend_bwd_cm(
            g.data_ptr(), counts.data_ptr(), tentry.data_ptr(), dout.data_ptr(), dg.data_ptr(), scratch.data_ptr(),
            T, MAX // G_CHUNK, tiles_x, int(tile_offset), torch.cuda.current_stream(g.device).cuda_stream,
        )
    _raise_on(err, counter)
    launches[counter] += 1
    return dg


def blend_permuted_gm_bwd(g: torch.Tensor, counts: torch.Tensor, tids: torch.Tensor, tentry: torch.Tensor,
                          dout: torch.Tensor, tiles_x: int):
    """dL/dg (T, MAX, 10) of ``blend_permuted_gm``: the kernel on CUDA, the
    plain version on the CPU. Rows past the count get exactly 0."""
    _check(g, counts, tids, max_axis=1, rows=ROWS_GM, rows_axis=2)
    _check_bwd(g, tentry, dout, g.shape[0], g.shape[1] // G_CHUNK)
    if g.device.type == "cpu":
        plain_bwd_calls["blend_permuted_gm_bwd"] += 1
        return blend_permuted_gm_bwd_plain(g, counts, tids, tentry, dout, tiles_x)
    T, MAX, _ = g.shape
    dg = torch.empty_like(g)
    if T == 0 or MAX == 0:
        return dg
    scratch = _bwd_scratch(g, T, MAX // G_CHUNK)
    lib = load_library()
    with torch.cuda.device(g.device):
        err = lib.riggs_blend_bwd_gm_permuted(
            g.data_ptr(), counts.data_ptr(), tids.data_ptr(), tentry.data_ptr(), dout.data_ptr(),
            dg.data_ptr(), scratch.data_ptr(), T, MAX // G_CHUNK, tiles_x,
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    _raise_on(err, "blend_permuted_gm_bwd")
    launches["blend_permuted_gm_bwd"] += 1
    return dg


def _check_runs(g_runs: torch.Tensor, counts: torch.Tensor, sblk: torch.Tensor):
    if g_runs.dtype != torch.float32 or g_runs.dim() != 2 or g_runs.shape[0] != PACK_ROWS:
        raise ValueError(f"g_runs must be float32 ({PACK_ROWS}, M2), got {g_runs.dtype} {tuple(g_runs.shape)}")
    if g_runs.shape[1] % G_CHUNK != 0 or g_runs.shape[1] == 0:
        raise ValueError(f"M2 = {g_runs.shape[1]} is not a positive multiple of {G_CHUNK}")
    for name, a in (("counts", counts), ("sblk", sblk)):
        if a.dtype != torch.int32 or a.dim() != 1 or a.shape != counts.shape or a.device != g_runs.device:
            raise ValueError(f"{name} must be int32 (T,) on {g_runs.device}, got {a.dtype} {tuple(a.shape)} on {a.device}")
    if g_runs.device.type == "cuda":
        if not (g_runs.is_contiguous() and counts.is_contiguous() and sblk.is_contiguous()):
            raise ValueError("the blend kernels take contiguous tensors")
    elif g_runs.device.type != "cpu":
        raise ValueError(f"unsupported device {g_runs.device}")


def blend_runs_fwd(g_runs: torch.Tensor, counts: torch.Tensor, sblk: torch.Tensor, chunks: int, tiles_x: int):
    """Aligned-runs blend, no gradient: the kernel on CUDA, the plain
    version on the CPU. Returns (out, tentry (T, chunks, 1024))."""
    _check_runs(g_runs, counts, sblk)
    if g_runs.device.type == "cpu":
        return blend_runs_plain(g_runs, counts, sblk, chunks, tiles_x)
    T = counts.shape[0]
    out, tentry = _outputs(g_runs, T, chunks)
    if T == 0 or chunks == 0:
        return out, tentry
    scratch = _fwd_scratch(g_runs, T, chunks)
    lib = load_library()
    with torch.cuda.device(g_runs.device):
        err = lib.riggs_blend_fwd_runs(
            g_runs.data_ptr(), counts.data_ptr(), sblk.data_ptr(), out.data_ptr(), tentry.data_ptr(),
            scratch.data_ptr(), T, chunks, g_runs.shape[1] // G_CHUNK, tiles_x,
            torch.cuda.current_stream(g_runs.device).cuda_stream,
        )
    _raise_on(err, "blend_runs")
    launches["blend_runs"] += 1
    return out, tentry


def blend_runs_bwd(g_runs: torch.Tensor, counts: torch.Tensor, sblk: torch.Tensor, tentry: torch.Tensor,
                   dout: torch.Tensor, tiles_x: int):
    """dL/dg_runs (16, M2) of ``blend_runs``: the kernel on CUDA, the plain
    version on the CPU."""
    _check_runs(g_runs, counts, sblk)
    T = counts.shape[0]
    _check_bwd(g_runs, tentry, dout, T, tentry.shape[1] if tentry.dim() == 3 else 0)
    if g_runs.device.type == "cpu":
        plain_bwd_calls["blend_runs_bwd"] += 1
        return blend_runs_bwd_plain(g_runs, counts, sblk, tentry, dout, tiles_x)
    if T == 0 or tentry.shape[1] == 0:
        return torch.zeros_like(g_runs)
    dg = torch.empty_like(g_runs)  # the C entry zeroes it on the stream first
    scratch = _bwd_scratch(g_runs, T, tentry.shape[1])
    lib = load_library()
    with torch.cuda.device(g_runs.device):
        err = lib.riggs_blend_bwd_runs(
            g_runs.data_ptr(), counts.data_ptr(), sblk.data_ptr(), tentry.data_ptr(), dout.data_ptr(),
            dg.data_ptr(), scratch.data_ptr(), T, tentry.shape[1], g_runs.shape[1] // G_CHUNK, tiles_x,
            torch.cuda.current_stream(g_runs.device).cuda_stream,
        )
    _raise_on(err, "blend_runs_bwd")
    launches["blend_runs_bwd"] += 1
    return dg


class BlendFn(torch.autograd.Function):
    """A blend with its gradient: ``apply(g, fwd, bwd, tiles_x, *index)``
    returns ``fwd(g, *index, tiles_x)``'s (out, tentry); the gradient of g is
    ``bwd(g, *index, tentry, dout, tiles_x)``. ``index`` is (counts,),
    (counts, tids) or (counts, sblk); tentry and the index get no gradient."""

    @staticmethod
    def forward(ctx, g, fwd, bwd, tiles_x, *index):
        out, tentry = fwd(g, *index, tiles_x)
        ctx.mark_non_differentiable(tentry)
        ctx.save_for_backward(g, tentry, *index)
        ctx.bwd, ctx.tiles_x = bwd, tiles_x
        return out, tentry

    @staticmethod
    def backward(ctx, dout, _dtentry):
        with trace.span("riggs.blend.bwd"):
            g, tentry, *index = ctx.saved_tensors
            # dout arrives strided from the untile transposes
            dg = ctx.bwd(g, *index, tentry, dout.contiguous(), ctx.tiles_x)
        return (dg, None, None, None) + (None,) * len(index)


def blend_cm(g: torch.Tensor, counts: torch.Tensor, tiles_x: int):
    """Channel-major blend of plain windows. g: (T, 16, MAX) f32, counts:
    (T,) int32 hit counts (chunk predication). Returns (out, tentry);
    differentiable in g."""
    with trace.span("riggs.blend.fwd"):
        return BlendFn.apply(g, blend_cm_fwd, blend_cm_bwd, tiles_x, counts)


class _ShardedBlend(torch.autograd.Function):
    """(T_pad, 16, MAX) windows -> (T_pad, 8, 1024) out: the rank's slice of
    tiles blended with its offset, the slices gathered over the tile group;
    backward the same in reverse."""

    @staticmethod
    def forward(ctx, gp, counts, tiles_x, mesh):
        per = gp.shape[0] // mesh.shape["tile"]
        lo = mesh.tile * per
        g_l, c_l = gp[lo:lo + per].contiguous(), counts[lo:lo + per].contiguous()
        out_l, tentry = blend_cm_fwd(g_l, c_l, tiles_x, lo, counter="blend_cm_offset")
        ctx.save_for_backward(g_l, c_l, tentry)
        ctx.lo, ctx.per, ctx.tiles_x, ctx.mesh = lo, per, tiles_x, mesh
        return mesh.gather_tiles(out_l)

    @staticmethod
    def backward(ctx, dout):
        with trace.span("riggs.blend.bwd"):
            g_l, c_l, tentry = ctx.saved_tensors
            dout_l = dout[ctx.lo:ctx.lo + ctx.per].contiguous()
            dg_l = blend_cm_bwd(g_l, c_l, tentry, dout_l, ctx.tiles_x, ctx.lo, counter="blend_cm_offset_bwd")
            return ctx.mesh.gather_tiles(dg_l), None, None, None


def sharded_blend(mesh, gp: torch.Tensor, counts: torch.Tensor, tiles_x: int) -> torch.Tensor:
    """``blend_cm``'s out (T, 8, 1024) of the windows gp (T, 16, MAX) with
    the tiles split over the tile group of ``mesh`` (a ``parallel.mesh.Mesh``:
    its group's size and this rank's index in it, and ``gather_tiles``):
    T is padded to a multiple of the group's size with empty tiles, and the
    rank blends its contiguous slice, local tile t being the image's tile
    t + the slice's start (the entry ``pallas_blend_offset``). Every rank
    gets the whole out; differentiable in gp.

    The gradient is ``shard_map``'s transpose: the backward slices dout to
    the rank's shard, runs the offset backward and gathers the shards' dg
    into the whole (T_pad, 16, MAX) tensor, so every rank then runs the
    same replicated backward upstream and gets the single-device gradient
    (bit for bit on the card, whose backward reduces each (tile, chunk)
    pair on its own); no parameter gradient needs an all-reduce over the
    tile group. ``torch.distributed.nn.functional.all_gather`` is not used:
    its backward sums the cotangents over the ranks, which would scale the
    gradient of a loss every rank computes alike by the group's size."""
    with trace.span("riggs.blend.fwd"):
        T = gp.shape[0]
        pad_t = (-T) % mesh.shape["tile"]
        if pad_t:
            gp = torch.nn.functional.pad(gp, (0, 0, 0, 0, 0, pad_t))
            counts = torch.nn.functional.pad(counts, (0, pad_t))
        return _ShardedBlend.apply(gp, counts, tiles_x, mesh)[:T]


def blend_permuted_gm(g: torch.Tensor, counts: torch.Tensor, tids: torch.Tensor, tiles_x: int):
    """Gaussian-major blend of laddered windows. g: (T, MAX, 10) f32, counts:
    (T,) int32 (rows past the count are masked), tids: (T,) int32 real tile
    id per row. Returns (out, tentry); differentiable in g."""
    with trace.span("riggs.blend.fwd"):
        return BlendFn.apply(g, blend_permuted_gm_fwd, blend_permuted_gm_bwd, tiles_x, counts, tids)


def blend_runs(g_runs: torch.Tensor, counts: torch.Tensor, sblk: torch.Tensor, chunks: int, tiles_x: int):
    """Blend of one aligned-runs array. g_runs: (16, M2) f32 channel-major
    slots, counts: (T,) int32 hit counts clamped to chunks * 128, sblk: (T,)
    int32 first block of each tile's run. Returns (out, tentry (T, chunks,
    1024)); differentiable in g_runs."""
    fwd = lambda g, c, s, tx: blend_runs_fwd(g, c, s, chunks, tx)
    with trace.span("riggs.blend.fwd"):
        return BlendFn.apply(g_runs, fwd, blend_runs_bwd, tiles_x, counts, sblk)
