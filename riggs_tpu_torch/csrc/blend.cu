// Fused per-tile front-to-back Gaussian blend and its backward, for Hopper (sm_90a).
//
// Replaces the three forward Pallas kernels of riggs_tpu/render/pallas_blend.py:
//   riggs_blend_fwd_cm          <- _fwd_kernel      (:179, entry pallas_blend)
//   riggs_blend_fwd_gm_permuted <- _fwd_kernel_gm   (:602, entry pallas_blend_permuted_gm)
//   riggs_blend_fwd_runs        <- _fwd_kernel_runs (:347, entry pallas_blend_runs)
// One template, over the layout of the attribute rows, gives all three; each
// instantiation is its own kernel. The three backward kernels follow below
// the forward.
//
// Design. One thread block per 32x32 tile, one thread per pixel (1024). The
// TPU kernel walked a (tile, chunk) grid sequentially and kept the
// transmittance in VMEM scratch between grid steps; here the chunk axis is a
// loop inside the block and the running transmittance lives in a register.
// Each 128-Gaussian chunk's 10 attribute rows are staged in shared memory
// with coalesced loads (5 KB), then every thread walks the rows front to
// back. The block-wide "any pixel still has T >= 1e-4" chunk skip is one
// __syncthreads_or. The TPU's log-space cumsum (a triangular matmul on the
// MXU) becomes a running sum per pixel, in the same order as the plain
// PyTorch version's torch.cumsum along the chunk.
//
// What bounds it on an H100: per (Gaussian, pixel) pair the blend does ~32
// FP32 operations, three of them on the special-function unit (exp of the
// EWA power, log1p, exp of the log-sum), against ~64 bytes per Gaussian and
// 4 bytes per pixel and chunk (tentry) moved. At the slice's shapes that is
// operation-bound by two orders of magnitude, and the SFU (16 ops/clk/SM,
// an eighth of the FP32 rate) is the unit that saturates first. This design
// does nothing about that yet: a later version can skip the exp/log pair for
// pixels past saturation, and use tensor cores for the [rgb, depth, 1] * w
// accumulation.
//
// The EWA power and alpha are computed with explicit round-to-nearest
// intrinsics, in the plain version's operation order, so that no fused
// multiply-add moves a value across the 1/255 or 1e-4 thresholds relative
// to that version.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int P = TILE * TILE;  // pixels per tile, one thread each
constexpr int G = 128;          // Gaussians per chunk
constexpr int ATTRS = 10;       // mx, my, conic a b c, opacity, rgb, depth
constexpr int PACK_ROWS = 16;   // channel-major row stride
constexpr int OUT_ROWS = 8;     // rgb, depth, acc, 3 zero rows
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

// The layout of the attribute rows (the template parameter L):
// kCM:   g is (T, 16, MAX) channel-major, tile t renders tile t, every row
//        of an active chunk is blended (the caller masked opacity).
// kGM:   g is (T, MAX, 10) gaussian-major, tile t renders tids[t], rows at
//        or past counts[t] are masked.
// kRuns: g is (16, M2) channel-major over one aligned-runs slot array (row
//        stride M2 = m2b * G); chunk c of tile t reads the 128-slot block
//        runs_block(...), tile t renders tile t, and every row of an active
//        chunk is blended (slots past the count are zero rows).
enum Layout : int { kCM, kGM, kRuns };

// pallas_blend.py:_runs_gidx: the run's block sblk[t] + c while the chunk
// starts before the count, else the spare last block; clamped to it, so an
// instance-budget overflow never reads past M2
__device__ __forceinline__ int runs_block(const int* sblk, int t, int c, int count, int m2b) {
  const int nblk = (count + G - 1) / G;
  return min(c < nblk ? sblk[t] + c : m2b - 1, m2b - 1);
}

// Stage chunk c's ten attribute rows in shared memory, coalesced.
template <int L>
__device__ __forceinline__ void load_chunk(float (*sg)[G], const float* __restrict__ g, int t, int c,
                                           size_t MAX, int blk, int m2b, int p) {
  for (int k = p; k < ATTRS * G; k += P) {
    if (L == kGM) {
      sg[k % ATTRS][k / ATTRS] = g[((size_t)t * MAX + (size_t)c * G) * ATTRS + k];
    } else if (L == kCM) {
      sg[k / G][k % G] = g[((size_t)t * PACK_ROWS + k / G) * MAX + (size_t)c * G + k % G];
    } else {
      sg[k / G][k % G] = g[(size_t)(k / G) * m2b * G + (size_t)blk * G + k % G];
    }
  }
}

template <int L>
__global__ void __launch_bounds__(P)
blend_fwd(const float* __restrict__ g, const int* __restrict__ counts,
          const int* __restrict__ tids, const int* __restrict__ sblk, int m2b,
          float* __restrict__ out, float* __restrict__ tentry, int C, int tiles_x) {
  __shared__ float sg[ATTRS][G];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int tile = L == kGM ? tids[t] : t;
  const int count = counts[t];
  const size_t MAX = (size_t)C * G;
  const float px = (float)((tile % tiles_x) * TILE + p % TILE);
  const float py = (float)((tile / tiles_x) * TILE + p / TILE);

  float trun = 1.0f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, acc_w = 0.f;
  for (int c = 0; c < C; ++c) {
    tentry[((size_t)t * C + c) * P + p] = trun;
    // both conditions are uniform over the block
    if (c * G >= count) continue;
    if (!__syncthreads_or(trun >= T_EPS)) continue;

    load_chunk<L>(sg, g, t, c, MAX, L == kRuns ? runs_block(sblk, t, c, count, m2b) : 0, m2b, p);
    __syncthreads();

    const int n = L == kGM ? min(G, count - c * G) : G;
    const float t0 = trun;
    float cum = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float dx = __fsub_rn(px, sg[0][j]);
      const float dy = __fsub_rn(py, sg[1][j]);
      const float quad = __fadd_rn(__fmul_rn(__fmul_rn(sg[2][j], dx), dx),
                                   __fmul_rn(__fmul_rn(sg[4][j], dy), dy));
      const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(sg[3][j], dx), dy));
      if (power > 0.0f) continue;
      const float alpha = fminf(__fmul_rn(sg[5][j], expf(power)), ALPHA_MAX);
      if (alpha < ALPHA_MIN) continue;  // alpha 0 adds nothing to the sum or the weights
      cum = __fadd_rn(cum, log1pf(-alpha));
      const float t_in = __fmul_rn(t0, expf(cum));
      if (t_in < T_EPS) continue;
      const float w = __fmul_rn(alpha, __fdiv_rn(t_in, __fsub_rn(1.0f, alpha)));
      acc_r += w * sg[6][j];
      acc_g += w * sg[7][j];
      acc_b += w * sg[8][j];
      acc_d += w * sg[9][j];
      acc_w += w;
    }
    trun = __fmul_rn(t0, expf(cum));
    __syncthreads();  // every thread is done with sg before the next chunk's loads
  }

  float* o = out + (size_t)t * OUT_ROWS * P + p;
  o[0 * P] = acc_r;
  o[1 * P] = acc_g;
  o[2 * P] = acc_b;
  o[3 * P] = acc_d;
  o[4 * P] = acc_w;
  o[5 * P] = 0.0f;
  o[6 * P] = 0.0f;
  o[7 * P] = 0.0f;
}

// ---------------------------------------------------------------------------
// Backward. Replaces the three backward Pallas kernels:
//   riggs_blend_bwd_cm          <- _bwd_kernel / _bwd_body           (:221/:251)
//   riggs_blend_bwd_gm_permuted <- _bwd_kernel_gm / _bwd_body_gm     (:638/:666)
//   riggs_blend_bwd_runs        <- _bwd_kernel_runs / _bwd_body_runs (:379/:404)
//
// Math (per pixel, for the Gaussians j of a chunk in blend order):
//   te_j  = t_in_j / (1 - alpha_j) * [t_in_j >= 1e-4],  w_j = alpha_j * te_j
//   vdc_j = [rgb, depth, 1]_j . dC
//   suf_j = sum over later Gaussians of w * vdc (this chunk and later ones)
//   dalpha_j = te_j * vdc_j - suf_j / (1 - alpha_j)
//   draw_j = dalpha_j * [1/255 <= raw_j < 0.99],  dpower_j = draw_j * raw_j
// and per Gaussian, summed over the tile's pixels. kCM and kGM take the five
// moments dx*dpower, dy*dpower, dx*dx*dpower, dx*dy*dpower, dy*dy*dpower and
// dpower, then d(mx, my, conic a b c, opacity) from them per Gaussian, as
// _bwd_body does. kRuns sums _bwd_body_runs's own six terms directly:
// (a dx + b dy) dpower, (c dy + b dx) dpower, -dx dx dpower / 2,
// -dx dy dpower, -dy dy dpower / 2 and draw * exp(power) (raw >= 1/255
// implies power <= 0, _bwd_body_runs's extra pass condition). All three take
// w * dC[0:4] for d(rgb, depth).
//
// Design. One block per tile, one thread per pixel, chunks walked from last
// to first with the suffix of later chunks in a register (the TPU carried it
// in VMEM scratch between grid steps). Inside a chunk two sweeps run in
// blend order: the first sums s_total = sum_j w_j vdc_j, the second
// recomputes cum, t_in and w with the forward's intrinsics in the forward's
// order (so every threshold falls as it fell in the forward) and takes
// suf_j = (s_total - s_incl_j) + suffix, the reference's own expression.
// The per-Gaussian sums over 1024 pixels go in rounds of 32 Gaussians:
// warp shuffles (skipped when no lane of the warp touches the Gaussian),
// then per-warp partials in shared memory summed in warp order, so the
// result is deterministic. Each (tile, row) of dg belongs to one block: no
// global atomics. Rows before the count in a chunk that no pixel enters with
// T >= 1e-4 get zeros as their true gradient.
//
// kCM and kGM write every element of dg. The zeros of chunks past the count
// and of the channel-major padding rows are defensive (the window gathers'
// backward zeroes invalid slots, pad's backward drops the padding rows):
// they keep dg equal to its plain version element for element. Together they
// cost one write of the skipped chunks' rows, most of the 230 MB of a
// channel-major dg at 800x800.
//
// kRuns: the Pallas kernel writes zeros to the blocks of inactive chunks,
// revisits the spare block with them, and never writes the blocks past the
// last run, whose slots carry the sentinel id that the gather's backward
// drops. Here the C entry zeroes the whole dg with one cudaMemsetAsync on
// the stream, and each active (tile, chunk) writes its own block once; the
// runs are disjoint, so no two blocks share one. A chunk that resolves to
// the spare block (only past an instance-budget overflow, a truncated render
// that render_auto escalates) writes nothing, where the TPU's last visitor
// won: the spare block stays zero.
//
// What bounds it on an H100: like the forward, operations (two sweeps of
// the EWA power and alpha per pair, three special-function operations per
// blended pair and sweep) plus the shuffles of the reductions; bytes are
// the g rows, tentry, dout and dg, tens of MB.

constexpr int SUB = 32;       // Gaussians per reduction round
constexpr int NW = P / 32;    // warps per block
constexpr int NV = 10;        // sums per Gaussian
constexpr unsigned FULL = 0xffffffffu;

// [r, g, b, depth, 1] . dC with explicit rounding: both sweeps must give the
// same bits, so that s_total - s_incl is exactly 0 after the last term
__device__ __forceinline__ float value_dot(float r, float g, float b, float d, float c0,
                                           float c1, float c2, float c3, float c4) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r, c0), __fmul_rn(g, c1)),
                                       __fmul_rn(b, c2)), __fmul_rn(d, c3)), c4);
}

template <int L>
__device__ __forceinline__ void zero_chunk(float* dg, int t, int c, size_t MAX, int p) {
  if (L == kGM) {
    float* d = dg + ((size_t)t * MAX + (size_t)c * G) * ATTRS;
    for (int k = p; k < G * ATTRS; k += P) d[k] = 0.0f;
  } else if (L == kCM) {
    for (int k = p; k < PACK_ROWS * G; k += P)
      dg[((size_t)t * PACK_ROWS + k / G) * MAX + (size_t)c * G + k % G] = 0.0f;
  }  // kRuns: dg was zeroed before the launch
}

template <int L>
__global__ void __launch_bounds__(P)
blend_bwd(const float* __restrict__ g, const int* __restrict__ counts,
          const int* __restrict__ tids, const int* __restrict__ sblk, int m2b,
          const float* __restrict__ tentry, const float* __restrict__ dout,
          float* __restrict__ dg, int C, int tiles_x) {
  __shared__ float sg[ATTRS][G];
  __shared__ float part[NW][SUB][NV];  // per-warp partial sums of one round
  __shared__ float msum[SUB][NV];      // block sums of one round
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int tile = L == kGM ? tids[t] : t;
  const int count = counts[t];
  const size_t MAX = (size_t)C * G;
  const float px = (float)((tile % tiles_x) * TILE + p % TILE);
  const float py = (float)((tile / tiles_x) * TILE + p / TILE);
  const float* dp = dout + (size_t)t * OUT_ROWS * P + p;
  const float dc0 = dp[0 * P], dc1 = dp[1 * P], dc2 = dp[2 * P], dc3 = dp[3 * P], dc4 = dp[4 * P];

  float suffix = 0.0f;
  for (int c = C - 1; c >= 0; --c) {
    // both conditions are uniform over the block; tentry is read only for
    // chunks that start before the count
    if (c * G >= count) {
      zero_chunk<L>(dg, t, c, MAX, p);
      continue;
    }
    const float t0 = tentry[((size_t)t * C + c) * P + p];
    if (!__syncthreads_or(t0 >= T_EPS)) {
      zero_chunk<L>(dg, t, c, MAX, p);
      continue;
    }
    const int blk = L == kRuns ? runs_block(sblk, t, c, count, m2b) : 0;
    const bool store = L != kRuns || blk < m2b - 1;
    load_chunk<L>(sg, g, t, c, MAX, blk, m2b, p);
    __syncthreads();
    const int n = L == kGM ? min(G, count - c * G) : G;
    // a pixel entering below 1e-4 blends nothing here (t_in <= t0) and has a
    // zero suffix: it only joins the reductions
    const bool live = t0 >= T_EPS;

    // sweep 1: s_total
    float s_total = 0.0f;
    if (live) {
      float cum = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float dx = __fsub_rn(px, sg[0][j]);
        const float dy = __fsub_rn(py, sg[1][j]);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(sg[2][j], dx), dx),
                                     __fmul_rn(__fmul_rn(sg[4][j], dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(sg[3][j], dx), dy));
        if (power > 0.0f) continue;
        const float alpha = fminf(__fmul_rn(sg[5][j], expf(power)), ALPHA_MAX);
        if (alpha < ALPHA_MIN) continue;
        cum = __fadd_rn(cum, log1pf(-alpha));
        const float t_in = __fmul_rn(t0, expf(cum));
        if (t_in < T_EPS) continue;
        const float w = __fmul_rn(alpha, __fmul_rn(t_in, __fdiv_rn(1.0f, __fsub_rn(1.0f, alpha))));
        const float vdc = value_dot(sg[6][j], sg[7][j], sg[8][j], sg[9][j], dc0, dc1, dc2, dc3, dc4);
        s_total = __fadd_rn(s_total, __fmul_rn(w, vdc));
      }
    }

    // sweep 2: per-pair gradients, reduced over the tile in rounds of SUB
    float cum = 0.0f, s_incl = 0.0f;
    for (int j0 = 0; j0 < G; j0 += SUB) {
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = j0 + jj;
        float v[NV];
#pragma unroll
        for (int k = 0; k < NV; ++k) v[k] = 0.0f;
        bool nz = false;
        if (live && j < n) {
          const float dx = __fsub_rn(px, sg[0][j]);
          const float dy = __fsub_rn(py, sg[1][j]);
          const float quad = __fadd_rn(__fmul_rn(__fmul_rn(sg[2][j], dx), dx),
                                       __fmul_rn(__fmul_rn(sg[4][j], dy), dy));
          const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(sg[3][j], dx), dy));
          const float e = power > 0.0f ? 0.0f : expf(power);
          const float raw = __fmul_rn(sg[5][j], e);
          const float alpha = fminf(raw, ALPHA_MAX);
          if (alpha >= ALPHA_MIN) {
            cum = __fadd_rn(cum, log1pf(-alpha));
            const float t_in = __fmul_rn(t0, expf(cum));
            const float inv_onem = __fdiv_rn(1.0f, __fsub_rn(1.0f, alpha));
            const float te = t_in >= T_EPS ? __fmul_rn(t_in, inv_onem) : 0.0f;
            const float w = __fmul_rn(alpha, te);
            const float vdc = value_dot(sg[6][j], sg[7][j], sg[8][j], sg[9][j], dc0, dc1, dc2, dc3, dc4);
            s_incl = __fadd_rn(s_incl, __fmul_rn(w, vdc));
            const float suf = __fadd_rn(__fsub_rn(s_total, s_incl), suffix);
            const float dalpha = __fsub_rn(__fmul_rn(te, vdc), __fmul_rn(suf, inv_onem));
            // raw >= alpha >= 1/255 here; at raw >= 0.99 the clamp stops the gradient
            const float draw = raw < ALPHA_MAX ? dalpha : 0.0f;
            const float dpower = __fmul_rn(draw, raw);
            if (L == kRuns) {
              v[0] = (sg[2][j] * dx + sg[3][j] * dy) * dpower;
              v[1] = (sg[4][j] * dy + sg[3][j] * dx) * dpower;
              v[2] = -0.5f * dx * dx * dpower;
              v[3] = -dx * dy * dpower;
              v[4] = -0.5f * dy * dy * dpower;
              v[5] = draw * e;
            } else {
              const float dpx = dx * dpower;
              const float dpy = dy * dpower;
              v[0] = dpx;
              v[1] = dpy;
              v[2] = dx * dpx;
              v[3] = dy * dpx;
              v[4] = dy * dpy;
              v[5] = dpower;
            }
            v[6] = w * dc0;
            v[7] = w * dc1;
            v[8] = w * dc2;
            v[9] = w * dc3;
            nz = (w != 0.0f) || (dpower != 0.0f) || (draw != 0.0f);
          }
        }
        if (__any_sync(FULL, nz)) {
#pragma unroll
          for (int k = 0; k < NV; ++k) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(FULL, v[k], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < NV; ++k) part[warp][jj][k] = v[k];
        }
      }
      __syncthreads();
      if (p < SUB * NV) {
        const int jj = p / NV, k = p % NV;
        float s = 0.0f;
        for (int w = 0; w < NW; ++w) s += part[w][jj][k];
        msum[jj][k] = s;
      }
      __syncthreads();
      // assemble d(mx, my, a, b, c, op, rgb, depth) of the round's Gaussians
      const int jj = L == kGM ? p / NV : p % SUB;
      const int k = L == kGM ? p % NV : p / SUB;
      if (store && p < SUB * (L == kCM ? PACK_ROWS : NV)) {
        const int j = j0 + jj;
        const float* m = msum[jj];
        float val = 0.0f;
        if (j < n) {
          if (L == kRuns) {
            val = m[k];
          } else {
            switch (k) {
              case 0: val = sg[2][j] * m[0] + sg[3][j] * m[1]; break;
              case 1: val = sg[4][j] * m[1] + sg[3][j] * m[0]; break;
              case 2: val = -0.5f * m[2]; break;
              case 3: val = -m[3]; break;
              case 4: val = -0.5f * m[4]; break;
              case 5: val = m[5] / fmaxf(sg[5][j], 1e-12f); break;
              case 6: case 7: case 8: case 9: val = m[k]; break;
              default: break;  // channel-major padding rows 10..15
            }
          }
        }
        if (L == kGM) {
          dg[((size_t)t * MAX + (size_t)c * G + j) * ATTRS + k] = val;
        } else if (L == kCM) {
          dg[((size_t)t * PACK_ROWS + k) * MAX + (size_t)c * G + j] = val;
        } else {
          dg[(size_t)k * m2b * G + (size_t)blk * G + j] = val;
        }
      }
    }
    suffix = __fadd_rn(suffix, s_total);
    __syncthreads();  // every thread is done with sg and msum before the next chunk
  }
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; stream is a
// cudaStream_t. Returns the launch's cudaError_t (0 on success).
extern "C" int riggs_blend_fwd_cm(const float* g, const int* counts, float* out,
                                  float* tentry, int T, int C, int tiles_x,
                                  void* stream) {
  blend_fwd<kCM><<<T, P, 0, (cudaStream_t)stream>>>(g, counts, nullptr, nullptr, 0, out, tentry, C, tiles_x);
  return (int)cudaGetLastError();
}

extern "C" int riggs_blend_fwd_gm_permuted(const float* g, const int* counts,
                                           const int* tids, float* out, float* tentry,
                                           int T, int C, int tiles_x, void* stream) {
  blend_fwd<kGM><<<T, P, 0, (cudaStream_t)stream>>>(g, counts, tids, nullptr, 0, out, tentry, C, tiles_x);
  return (int)cudaGetLastError();
}

// g: (16, m2b * 128); counts, sblk: (T,); C chunks per tile
extern "C" int riggs_blend_fwd_runs(const float* g, const int* counts, const int* sblk,
                                    float* out, float* tentry, int T, int C, int m2b,
                                    int tiles_x, void* stream) {
  blend_fwd<kRuns><<<T, P, 0, (cudaStream_t)stream>>>(g, counts, nullptr, sblk, m2b, out, tentry, C, tiles_x);
  return (int)cudaGetLastError();
}

extern "C" int riggs_blend_bwd_cm(const float* g, const int* counts, const float* tentry,
                                  const float* dout, float* dg, int T, int C, int tiles_x,
                                  void* stream) {
  blend_bwd<kCM><<<T, P, 0, (cudaStream_t)stream>>>(g, counts, nullptr, nullptr, 0, tentry, dout, dg, C, tiles_x);
  return (int)cudaGetLastError();
}

extern "C" int riggs_blend_bwd_gm_permuted(const float* g, const int* counts, const int* tids,
                                           const float* tentry, const float* dout, float* dg,
                                           int T, int C, int tiles_x, void* stream) {
  blend_bwd<kGM><<<T, P, 0, (cudaStream_t)stream>>>(g, counts, tids, nullptr, 0, tentry, dout, dg, C, tiles_x);
  return (int)cudaGetLastError();
}

// dg: (16, m2b * 128), zeroed here on the stream before the launch
extern "C" int riggs_blend_bwd_runs(const float* g, const int* counts, const int* sblk,
                                    const float* tentry, const float* dout, float* dg,
                                    int T, int C, int m2b, int tiles_x, void* stream) {
  cudaError_t err = cudaMemsetAsync(dg, 0, (size_t)PACK_ROWS * m2b * G * sizeof(float), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (T == 0 || C == 0) return 0;
  blend_bwd<kRuns><<<T, P, 0, (cudaStream_t)stream>>>(g, counts, nullptr, sblk, m2b, tentry, dout, dg, C, tiles_x);
  return (int)cudaGetLastError();
}
