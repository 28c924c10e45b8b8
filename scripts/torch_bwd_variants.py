#!/usr/bin/env python3
"""Time the port's blend kernels (riggs_tpu_torch/csrc/blend.cu), backward
and forward, against variants of the same source on one CUDA card, on the
inputs of one full-width stage-2 training step.

    python3 scripts/torch_bwd_variants.py     # from the repository root, one card

Variants, each the shipped source with exact text substitutions (each must
match once), built in parallel into .torch_ext/variants/:
  shipped      the source as it is;
  no-cut       without the per-Gaussian power cut (no staged cut, no test),
               forward and backward;
  gm-256       the gaussian-major layout at 256 threads of 4 pixels, the
               backward at two blocks per SM (the other layouts' shape),
               instead of 512 of 2, backward and forward (they share
               Bwd<L>'s thread counts);
  all-512      every layout at 512 threads of 2 pixels (the gaussian-major
               shape), backward and forward;
  fwd-gm-256   the forward's gaussian-major layout at 256 threads of 4
               pixels instead of 512 of 2;
  fwd-all-512  every forward layout at 512 threads of 2 pixels;
  fwd-4-blocks the channel-major and runs forward at four blocks per SM
               (64 registers a thread) instead of two;
  fwd-wait     a forward chunk whose entry T is not published yet waits for
               it and then walks its rows once, instead of summing cum_end
               while it waits and walking them again for the weighted sums;
  fwd-abort    such a chunk stops summing cum_end, every 32 rows, once its
               tile is done (an earlier chunk was its first inactive one);
  fwd-scale    such a chunk walks its rows once as if its entry T were 1
               (cum_end and the sums), then scales the sums by its entry T
               where every weighted row stays >= 1e-4 at it (the others
               walk again);
  fwd-inplace  the chained forward with no sums scratch and no combine:
               each active chunk adds its sums into out once its tile's
               previous chunk has added its own
               (scripts/blend_fwd_inplace.cu replaces the forward's
               section);
  split        the forward in four launches (scripts/blend_fwd_split.cu
               replaces the forward's section): every started chunk's
               cum_end, a scan per tile, the active chunks' sums, the
               combine.
Inputs: chip_smoke.py's avatar (seed 0, 800x800, 100 000 Gaussians) and its
training frame; the blend calls of one make_stage2_auto step at it = 15001
on plain windows (blend_cm and its backward) and on the probe-fitted ladder
(blend_permuted_gm and its backward, one call per bucket). For each call,
CUDA-event ms per call over 10 calls, variants in turns (forward order, then
backward); each variant's result against the shipped one's (max |delta| of
dg or out, and whether the bits are equal; a forward variant's tentry must
have the shipped bits), and whether a second launch repeats the variant's
own bits; for a forward call, also the peak of memory allocated during one
call above what was allocated before it (outputs and scratch; each
variant's scratch at its own size).
Then the peak memory allocated during one whole step on each window path,
with the shipped forward and with each section variant's. Prints the card as
nvidia-smi names it. Imports nothing of JAX or
riggs_tpu.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _fwd_threads(nt):
    """Substitutions that give the forward kernel nt threads a block (the
    backward keeps Bwd<L>'s)."""
    return (("__launch_bounds__(Bwd<L>::NT, FWD_MIN_BLOCKS)", f"__launch_bounds__({nt}, FWD_MIN_BLOCKS)"),
            ("constexpr int BT = Bwd<L>::NT, PPT = P / BT;", f"constexpr int BT = {nt}, PPT = P / BT;"),
            ("blend_fwd<L><<<(unsigned)pairs, Bwd<L>::NT,", f"blend_fwd<L><<<(unsigned)pairs, {nt},"))


VARIANTS = {
    "shipped": (),
    "no-cut": (
        ("  if (!(pmax >= cut[j])) return false;\n", ""),
        ("  for (int j = threadIdx.x; j < G; j += BT) cut[j] = logf(ALPHA_MIN / sg[5][j]) - CUT;\n", ""),
    ),
    "gm-256": (
        ("static constexpr int NT = L == kGM ? 512 : 256;", "static constexpr int NT = 256;"),
        ("static constexpr int MIN_BLOCKS = L == kGM ? 1 : 2;", "static constexpr int MIN_BLOCKS = 2;"),
    ),
    "all-512": (
        ("static constexpr int NT = L == kGM ? 512 : 256;", "static constexpr int NT = 512;"),
        ("static constexpr int MIN_BLOCKS = L == kGM ? 1 : 2;", "static constexpr int MIN_BLOCKS = 1;"),
    ),
    "fwd-gm-256": _fwd_threads("(L == kGM ? 256 : Bwd<L>::NT)"),
    "fwd-all-512": _fwd_threads("512"),
    "fwd-4-blocks": (("__launch_bounds__(Bwd<L>::NT, FWD_MIN_BLOCKS)",
                      "__launch_bounds__(Bwd<L>::NT, L == kGM ? 2 : 4)"),),
    "fwd-wait": (
        ("    cum_rows(sg, cut, n, q, cum);\n", ""),
        ("  const int chain = s_chain;", "  int chain = s_chain;"),
        ("    if (s_chain == kDone) return;\n  }", "    if (s_chain == kDone) return;\n    chain = kReady;\n  }"),
    ),
    "fwd-abort": (
        ("    cum_rows(sg, cut, n, q, cum);\n", """    for (int j = 0; j < n; ++j) {
      // every 32 rows: stop once the tile is done (an earlier chunk was its first inactive one)
      if ((j & 31) == 31 && __syncthreads_or(threadIdx.x == 0 && atomicAdd(&done[t], 0))) return;
      float dx, dy[PPT], e[PPT], raw[PPT];
      bool hit[PPT], every[PPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) every[i] = true;
      if (!test_pixels(sg, cut, j, q, every, dx, dy, e, raw, hit)) continue;
#pragma unroll
      for (int i = 0; i < PPT; ++i) cum[i] = __fadd_rn(cum[i], log1pf(-(hit[i] ? fminf(raw[i], ALPHA_MAX) : 0.0f)));
    }
"""),
    ),
    "fwd-scale": (
        ("  float cum[PPT], acc[PPT][SUMS];\n", "  float cum[PPT], acc[PPT][SUMS], tmin[PPT];\n"),
        ("    cum[i] = 0.0f;\n#pragma unroll\n    for (int k = 0; k < SUMS; ++k) acc[i][k] = 0.0f;\n  }\n"
         "  if (chain == kPending) {",
         "    cum[i] = 0.0f;\n    tmin[i] = INFINITY;\n#pragma unroll\n"
         "    for (int k = 0; k < SUMS; ++k) acc[i][k] = 0.0f;\n  }\n  if (chain == kPending) {"),
        ("    cum_rows(sg, cut, n, q, cum);\n", """    // the sums as if t0 were 1, and each pixel's last weighted t_in
    for (int j = 0; j < n; ++j) {
      float dx, dy[PPT], e[PPT], raw[PPT];
      bool hit[PPT], every[PPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) every[i] = true;
      if (!test_pixels(sg, cut, j, q, every, dx, dy, e, raw, hit)) continue;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float alpha = hit[i] ? fminf(raw[i], ALPHA_MAX) : 0.0f;
        cum[i] = __fadd_rn(cum[i], log1pf(-alpha));
        const float t_in = expf(cum[i]);
        const bool on = hit[i] && t_in >= T_EPS;
        const float w = on ? __fmul_rn(alpha, __fdiv_rn(t_in, __fsub_rn(1.0f, alpha))) : 0.0f;
        tmin[i] = on ? t_in : tmin[i];
        acc[i][0] += w * sg[6][j];
        acc[i][1] += w * sg[7][j];
        acc[i][2] += w * sg[8][j];
        acc[i][3] += w * sg[9][j];
        acc[i][4] += w;
      }
    }
"""),
        ("#pragma unroll\n    for (int i = 0; i < PPT; ++i) cum[i] = 0.0f;\n"
         "    blend_rows<false>(sg, cut, n, q, cum, acc);\n",
         """    bool again = false;  // t0 times the sums where every weighted row stays >= 1e-4 at t0
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float t0 = q.t0[i];
      const bool keep = t0 >= T_EPS && __fmul_rn(t0, tmin[i]) >= T_EPS;
      again |= t0 >= T_EPS && !keep;
#pragma unroll
      for (int k = 0; k < SUMS; ++k) acc[i][k] = keep ? __fmul_rn(t0, acc[i][k]) : 0.0f;
      q.t0[i] = keep ? 0.0f : t0;  // a kept pixel is not walked again
      cum[i] = 0.0f;
    }
    if (__syncthreads_or(again)) blend_rows<false>(sg, cut, n, q, cum, acc);
"""),
    ),
}
# variants that replace the forward's section of the source (from its
# "// Forward:" line to the backward's) with a file's text; "split" takes
# the first bytes of the shipped forward's scratch, "fwd-inplace" a scratch
# of its own size, the chain state alone
SECTIONS = {"fwd-inplace": ROOT / "scripts" / "blend_fwd_inplace.cu",
            "split": ROOT / "scripts" / "blend_fwd_split.cu"}
SCRATCH_BYTES = {"fwd-inplace": lambda T, C: (1 + T * C + 2 * T) * 4 if T and C else 0}
FWD_SECTION = ("// Forward:", "// " + "-" * 75 + "\n// Backward.")
REPS = 10


def variant_source(src: str, name: str) -> str:
    """The source of variant ``name``: the substitutions of VARIANTS, each
    matching once, or the forward's section replaced by SECTIONS' file."""
    if name in SECTIONS:
        i = src.index(FWD_SECTION[0])
        j = src.index(FWD_SECTION[1], i)
        if src.count(FWD_SECTION[0]) != 1:
            raise RuntimeError(f"variant {name}: the forward section's start matches {src.count(FWD_SECTION[0])} times")
        return src[:i] + SECTIONS[name].read_text() + src[j:]
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old.strip()!r} matches {src.count(old)} times in blend.cu")
        src = src.replace(old, new)
    return src


def build_variants(B):
    """Every variant's source and library under .torch_ext/variants/, built
    in parallel; returns {name: bound ctypes library}."""
    from riggs_tpu_torch import cuda_build

    src = B.CSRC.read_text()
    out = cuda_build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in list(VARIANTS) + list(SECTIONS):
        path = out / f"blend_{name}.cu"
        path.write_text(variant_source(src, name))
        jobs[name] = (path, out / f"libblend_{name}.so")
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(cuda_build.build, s, lib) for s, lib in jobs.values()]:
            f.result()
    libs = {}
    for name, (_, lib) in jobs.items():
        regs = [l.split("Used")[1].split(",")[0].strip() for l in lib.with_suffix(".log").read_text().splitlines()
                if "Used" in l and "registers" in l]
        print(f"[build] {name}: registers per kernel {regs}")
        libs[name] = B.bind(ctypes.CDLL(str(lib)))
    return libs


def capture_step_calls(B, smoke):
    """The blend calls of one make_stage2_auto step at it = 15001 on plain
    windows and on the ladder, as chip_smoke.py's [train] makes them:
    ({wrapper name: [args, ...]}, {path: a function that runs one such step})."""
    import torch

    from riggs_tpu_torch.render.ladder import make_tile_ladder
    from riggs_tpu_torch.train.stage2 import make_stage2_auto

    gs, skel, cam, bg = smoke.build_avatar(0, smoke.N_ALIVE, smoke.CAPACITY, smoke.SIZE, "cuda")
    probe = [smoke.frame(gs, skel, cam, bg, t=t, max_per_tile=8192) for t in smoke.PROBE_TIMES]
    counts = np.stack([p["tile_counts"].cpu().numpy() for p in probe])
    cap = int(-(-counts.max() // 128) * 128)
    ladder = make_tile_ladder(counts)
    fr, pre_d_xyz, pre_d_joints, cfg = smoke.build_training(gs, skel, cam, bg, "cuda")
    step = make_stage2_auto(cfg, template_idx=0)
    calls, steps = {}, {}
    for path, names, kw in (("plain windows", ("blend_cm_fwd", "blend_cm_bwd"), dict(max_per_tile=cap)),
                            ("ladder", ("blend_permuted_gm_fwd", "blend_permuted_gm_bwd"),
                             dict(max_per_tile=cap, tile_ladder=ladder))):
        steps[path] = lambda kw=kw: step(smoke.fresh_state(gs, skel, smoke.TRAIN_ITS[-1], "cuda"), fr, smoke.UID, bg,
                                         pre_d_xyz, pre_d_joints, it=smoke.TRAIN_ITS[-1], **kw)
        with smoke._Capture(B, names) as c:
            steps[path]()
        calls.update(c.calls)
    torch.cuda.synchronize()
    print(f"[inputs] window {cap}, ladder {ladder}; calls "
          + "; ".join(f"{k}: {[tuple(a[0].shape) for a in v]}" for k, v in calls.items()))
    return calls, steps


def _peak_bytes(fn):
    """Peak bytes allocated while fn runs, above what was allocated before."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _same_bits(a, b):
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from riggs_tpu_torch.render import blend as B

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}")
    libs = build_variants(B)
    calls, steps = capture_step_calls(B, smoke)
    shipped_lib, shipped_scratch = B.load_library, B.fwd_scratch_bytes
    order = list(libs) + list(libs)[::-1]

    def use(v):  # variant v's library, and its forward's scratch size
        B.load_library = lambda lib=libs[v]: lib
        B.fwd_scratch_bytes = SCRATCH_BYTES.get(v, shipped_scratch)

    try:
        with torch.no_grad():
            for name, cs in calls.items():
                kern = getattr(B, name)
                fwd = name.endswith("_fwd")
                totals = {v: 0.0 for v in libs}
                for a in cs:
                    res, again, ms, peak = {}, {}, {v: [] for v in libs}, {}
                    for v in libs:
                        use(v)
                        res[v] = kern(*a)
                        again[v] = kern(*a)
                        if fwd:
                            peak[v] = _peak_bytes(lambda a=a: kern(*a))
                    for v in order:
                        use(v)
                        ms[v].append(smoke._event_ms(lambda a=a: kern(*a), REPS))
                    line = []
                    for v in libs:
                        m = sum(ms[v]) / len(ms[v])
                        totals[v] += m
                        if fwd:  # (out, tentry): tentry must keep its bits
                            (o, te), (o0, te0), (o2, te2) = res[v], res["shipped"], again[v]
                            if not _same_bits(te, te0):
                                raise RuntimeError(f"variant {v}: {name} tentry differs from the shipped one's")
                            d, same = float((o - o0).abs().max()), _same_bits(o, o0)
                            repeats = _same_bits(o, o2) and _same_bits(te, te2)
                        else:
                            d, same = float((res[v] - res["shipped"]).abs().max()), _same_bits(res[v], res["shipped"])
                            repeats = _same_bits(res[v], again[v])
                        line.append(f"{v} {ms[v][0]:.4f}/{ms[v][1]:.4f} ms (max|d| {d:.2e}{', same bits' if same else ''}"
                                    f"{'' if repeats else ', a second launch DIFFERS'}"
                                    f"{f', peak {peak[v]} bytes' if fwd else ''})")
                    print(f"[variants] {name} call {tuple(a[0].shape)}: " + "; ".join(line))
                print(f"[variants] {name} per step ({len(cs)} calls): "
                      + "; ".join(f"{v} {t:.4f} ms" for v, t in totals.items()))
        for path, run in steps.items():
            peaks = []
            for v in ("shipped", *SECTIONS):
                use(v)
                run()  # warm the allocator's cache
                peaks.append(f"{v} {_peak_bytes(run)}")
            print(f"[memory] one step on {path}, peak bytes allocated above the set-up: " + ", ".join(peaks))
    finally:
        B.load_library, B.fwd_scratch_bytes = shipped_lib, shipped_scratch
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
