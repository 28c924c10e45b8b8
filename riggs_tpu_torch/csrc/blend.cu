// Fused per-tile front-to-back Gaussian blend and its backward, for Hopper (sm_90a).
//
// Replaces the three forward Pallas kernels of riggs_tpu/render/pallas_blend.py:
//   riggs_blend_fwd_cm          <- _fwd_kernel      (:179, entry pallas_blend)
//   riggs_blend_fwd_gm_permuted <- _fwd_kernel_gm   (:602, entry pallas_blend_permuted_gm)
//   riggs_blend_fwd_runs        <- _fwd_kernel_runs (:347, entry pallas_blend_runs)
// One template, over the layout of the attribute rows, gives all three; each
// instantiation is its own kernel. The backward of each, three launches over
// (tile, chunk) pairs, follows below the forward.
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

// Stage chunk c's ten attribute rows in shared memory, coalesced, with NT
// threads (p is the thread's index).
template <int L, int NT>
__device__ __forceinline__ void load_chunk(float (*sg)[G], const float* __restrict__ g, int t, int c,
                                           size_t MAX, int blk, int m2b, int p) {
  for (int k = p; k < ATTRS * G; k += NT) {
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

    load_chunk<L, P>(sg, g, t, c, MAX, L == kRuns ? runs_block(sblk, t, c, count, m2b) : 0, m2b, p);
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
// Decomposition. suf_j splits into (s_total - s_incl_j), this chunk's own
// part, and the suffix: the sum of s_total = sum_j w_j vdc_j over the later
// chunks. A chunk's t_in starts from the forward's tentry, so the suffix is
// the only thing one chunk needs from another. The TPU walked each tile's
// chunks back to front on a sequential grid and carried the suffix in VMEM;
// here every (tile, chunk) pair is a block of its own, in three launches on
// the stream (one C entry):
//   (i)   blend_bwd_total<L>, grid T x C: an active pair's s_total per pixel
//         (sweep 1) into plane 0 of a (2, T, C, 1024) f32 scratch; a started
//         but inactive pair writes zeros, a pair past the count nothing;
//   (ii)  blend_bwd_suffix, one thread per (tile, pixel): plane 1 of the
//         scratch gets each started chunk's exclusive suffix, summed from the
//         last chunk to the first with __fadd_rn;
//   (iii) blend_bwd<L>, grid T x C: an active pair's sweep 2 with its own
//         s_total and suffix, and its own rows of dg.
// A pair is active when its chunk starts before the count and some pixel
// enters it with T >= 1e-4 (monotone: active chunks are a prefix of the
// tile's). Both sweeps round every product and sum explicitly (the
// forward's intrinsics in the forward's order, value_dot in both), so every
// threshold falls as in the forward, s_total - s_incl is exactly 0 after a
// pixel's last term, and s_total and the suffix have the bits of a block
// per tile walking its chunks last to first with the suffix in a register:
// they are per-pixel sums in the same order. Each dg row belongs to one pair: no atomics, and a second
// launch gives the same bits.
//
// Blocks. Each thread owns PPT pixels of one column (a warp spans 32 columns
// x PPT rows): kCM and kRuns 256 threads of 4 pixels, two or more blocks on
// an SM; kGM 512 threads of 2. The ladder's buckets hold few tiles with deep
// windows, so few pairs are active at once and a block's own latency sets the
// time; plain windows and runs keep the card full, and there 4 pixels per
// thread spread each Gaussian's per-warp overhead wider (on an H100 the
// 512-thread shape was faster on the ladder as a whole, though not on its
// 78-tile bucket, and slower on channel-major windows). Blocks are numbered
// chunk-major, so every tile's first chunk, the heaviest (all its pixels
// enter live), is dispatched first and the long blocks do not trail. Per
// Gaussian j a thread takes two steps over its pixels, each without branches
// so that their chains overlap: test_pixels (the EWA power with the column's
// dx, a dx dx and b dx shared, exp, alpha >= 1/255) and, if any pixel blends
// j, the transmittance step for all of them (log1p, exp, 1/(1 - alpha) by
// __frcp_rn, which rounds as __fdiv_rn(1, x) does), a pixel that misses j
// taking alpha = 0 and adding exact zeros. A per-Gaussian cut staged in
// shared memory (power < log(1/255 / opacity) - 1e-3 cannot reach alpha
// 1/255) skips the exps of a thread whose pixels all lie below it, and a
// pixel is dropped after its first t_in < 1e-4 (t_in only falls, so every
// later term of it is exactly 0); neither changes a bit. Sweep 2 sums each
// Gaussian's ten terms over the thread's pixels in registers, then over the
// warp by a reduce-scatter (12 shuffles instead of ten 5-step trees; skipped,
// and one flag stored, when no lane touched j), then over the warps in warp
// order in rounds of SUB Gaussians: the order is fixed. (Persistent blocks
// striding over the pairs were slower: the static stride unbalanced the
// active pairs.)
//
// Inactive pairs: kCM and kGM write their zeros (chunks past the count and
// chunks entered saturated: defensive, the window gathers' backward zeroes
// invalid slots, and pad's backward drops the channel-major padding rows;
// they keep dg equal to its plain version element for element; at 800x800
// most of a channel-major dg's 230 MB, ~0.07 ms of HBM writes). kRuns: the
// Pallas kernel writes zeros to the blocks of inactive chunks, revisits the
// spare block with them, and never writes the blocks past the last run,
// whose slots carry the sentinel id that the gather's backward drops. Here
// the C entry zeroes the whole dg with one cudaMemsetAsync on the stream,
// and each active (tile, chunk) writes its own block once; the runs are
// disjoint, so no two blocks share one. A chunk that resolves to the spare
// block (only past an instance-budget overflow, a truncated render that
// render_auto escalates) writes nothing, where the TPU's last visitor won:
// the spare block stays zero.
//
// What bounds it on an H100: (i) and (iii) issue, FP32 instructions and
// the special-function unit's exp, log1p and reciprocal (a warp's MUFU
// instruction takes 8 cycles), with no ILP but the thread's pixels, since
// cum chains the Gaussians of a pixel; not bytes (a chunk's rows are 5 KB,
// its tentry, dout and scratch 28 KB, read once). (ii) bytes: one read of
// s_total and one write of the suffix per started (chunk, pixel), 8 KB per
// started chunk, ~0.005 ms at 800x800.

// The shape of a backward block, by layout (see Blocks above): NT threads
// of PPT pixels each, one column (rows warp * PPT + i), BW warps, and at
// least MIN_BLOCKS blocks held by an SM (which caps registers per thread).
template <int L>
struct Bwd {
  static constexpr int NT = L == kGM ? 512 : 256;
  static constexpr int PPT = P / NT;
  static constexpr int BW = NT / 32;
  static constexpr int MIN_BLOCKS = L == kGM ? 1 : 2;
};
constexpr int SUFFIX_NT = 256;  // threads per block of the suffix pass
// a power below log(1/255 / opacity) - CUT leaves alpha below 1/255 whatever
// the rounding of expf and the product (errors ~1e-6 in the log)
constexpr float CUT = 1e-3f;
constexpr int SUB = 32;        // Gaussians per reduction round
constexpr int NV = 10;         // sums per Gaussian
constexpr unsigned FULL = 0xffffffffu;

// [r, g, b, depth, 1] . dC with explicit rounding: both sweeps must give the
// same bits, so that s_total - s_incl is exactly 0 after the last term
__device__ __forceinline__ float value_dot(float r, float g, float b, float d, const float* dc) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r, dc[0]), __fmul_rn(g, dc[1])),
                                       __fmul_rn(b, dc[2])), __fmul_rn(d, dc[3])), dc[4]);
}

// Zeros for every dg row of an inactive (tile, chunk), 16-byte stores.
template <int L>
__device__ __forceinline__ void zero_chunk(float* dg, int t, int c, size_t MAX, int tid) {
  constexpr int BT = Bwd<L>::NT;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (L == kGM) {
    float4* d = reinterpret_cast<float4*>(dg + ((size_t)t * MAX + (size_t)c * G) * ATTRS);
    for (int q = tid; q < G * ATTRS / 4; q += BT) d[q] = z;
  } else if (L == kCM) {
    for (int q = tid; q < PACK_ROWS * G / 4; q += BT)
      reinterpret_cast<float4*>(dg + ((size_t)t * PACK_ROWS + q / (G / 4)) * MAX + (size_t)c * G)[q % (G / 4)] = z;
  }  // kRuns: dg was zeroed before the launches
}

// What (i) and (iii) share: the pair's place, its pixels and their entry
// transmittance, and whether it is active (uniform over the block).
template <int PPT>
struct Pair {
  int t, c, count, lane, warp;
  float px, py0;
  float t0[PPT];
  size_t base;  // (t * C + c) * P: the pair's offset in tentry and in each scratch plane
};

template <int L>
__device__ __forceinline__ bool enter_pair(Pair<Bwd<L>::PPT>& q, const int* __restrict__ counts,
                                           const int* __restrict__ tids, const float* __restrict__ tentry, int T,
                                           int C, int tiles_x, bool& started) {
  constexpr int PPT = Bwd<L>::PPT;
  // chunk-major: the blocks of every tile's first chunk, the heaviest (all
  // its pixels enter live), are dispatched first
  q.c = blockIdx.x / T;
  q.t = blockIdx.x - q.c * T;
  q.count = counts[q.t];
  q.lane = threadIdx.x & 31;
  q.warp = threadIdx.x >> 5;
  q.base = ((size_t)q.t * C + q.c) * P;
  started = q.c * G < q.count;  // uniform; tentry is read only for started chunks
  if (!started) return false;
  const int tile = L == kGM ? tids[q.t] : q.t;
  q.px = (float)((tile % tiles_x) * TILE + q.lane);
  q.py0 = (float)((tile / tiles_x) * TILE + q.warp * PPT);
  bool live = false;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    q.t0[i] = tentry[q.base + (q.warp * PPT + i) * TILE + q.lane];
    live |= q.t0[i] >= T_EPS;
  }
  return __syncthreads_or(live);
}

template <int PPT>
__device__ __forceinline__ bool any_of(const bool (&a)[PPT]) {
  bool r = false;
#pragma unroll
  for (int i = 0; i < PPT; ++i) r |= a[i];
  return r;
}

// The cheap half of Gaussian j's step for the thread's pixels, without
// branches so that their PPT chains overlap: the EWA power (dx and its
// products shared by the column), exp(power) (0 where power > 0), raw =
// opacity * exp, and whether the pixel blends j (alive and alpha >= 1/255).
// Returns whether any of them does.
template <int PPT>
__device__ __forceinline__ bool test_pixels(const float (*sg)[G], const float* cut, int j, const Pair<PPT>& q,
                                            const bool (&alive)[PPT], float& dx, float (&dy)[PPT], float (&e)[PPT],
                                            float (&raw)[PPT], bool (&hit)[PPT]) {
  dx = __fsub_rn(q.px, sg[0][j]);
  const float adxdx = __fmul_rn(__fmul_rn(sg[2][j], dx), dx);
  const float bdx = __fmul_rn(sg[3][j], dx);
  float power[PPT];
  float pmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    dy[i] = __fsub_rn(q.py0 + (float)i, sg[1][j]);
    const float quad = __fadd_rn(adxdx, __fmul_rn(__fmul_rn(sg[4][j], dy[i]), dy[i]));
    power[i] = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(bdx, dy[i]));
    pmax = fmaxf(pmax, alive[i] ? power[i] : -INFINITY);
  }
  if (!(pmax >= cut[j])) return false;
  bool any = false;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const float ex = expf(power[i]);
    e[i] = power[i] > 0.0f ? 0.0f : ex;
    raw[i] = __fmul_rn(sg[5][j], e[i]);
    hit[i] = alive[i] && fminf(raw[i], ALPHA_MAX) >= ALPHA_MIN;
    any |= hit[i];
  }
  return any;
}

// Each staged Gaussian's power cut (CUT below log(1/255 / opacity); +inf
// for opacity 0), then a barrier.
template <int BT>
__device__ __forceinline__ void stage_cut(float* cut, const float (*sg)[G]) {
  for (int j = threadIdx.x; j < G; j += BT) cut[j] = logf(ALPHA_MIN / sg[5][j]) - CUT;
  __syncthreads();
}

// The ten sums of one Gaussian over the warp's lanes, reduce-scattered: 12
// shuffles in five halving steps (10 -> 5 -> 3 -> 2 -> 1 -> 1 values per
// lane) instead of ten 5-step trees. Returns the lane's sum; id is the sum's
// index, or -1: lanes 0-31 end with each of the ten sums exactly once.
__device__ __forceinline__ float reduce_scatter(const float (&v)[NV], int lane, int& id) {
  const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4, b2 = lane & 2, b1 = lane & 1;
  float a[5], c[3], d[2];
#pragma unroll
  for (int r = 0; r < 5; ++r) a[r] = (b16 ? v[5 + r] : v[r]) + __shfl_xor_sync(FULL, b16 ? v[r] : v[5 + r], 16);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float hi = r < 2 ? a[3 + r] : 0.0f;
    c[r] = (b8 ? hi : a[r]) + __shfl_xor_sync(FULL, b8 ? a[r] : hi, 8);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float hi = r < 1 ? c[2] : 0.0f;
    d[r] = (b4 ? hi : c[r]) + __shfl_xor_sync(FULL, b4 ? c[r] : hi, 4);
  }
  const float e = (b2 ? d[1] : d[0]) + __shfl_xor_sync(FULL, b2 ? d[0] : d[1], 2);
  const float f = (b1 ? 0.0f : e) + __shfl_xor_sync(FULL, b1 ? e : 0.0f, 1);
  const int ci = b4 ? 2 + b2 : b2;  // the slot of c that d[b2] summed
  const int ai = b8 ? 3 + ci : ci;  // the slot of a
  id = (b1 || ci > 2 || ai > 4) ? -1 : (b16 ? 5 : 0) + ai;
  return f;
}

template <int PPT>
__device__ __forceinline__ void load_dc(float (*dc)[5], const float* __restrict__ dout, const Pair<PPT>& q) {
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const float* d = dout + (size_t)q.t * OUT_ROWS * P + (q.warp * PPT + i) * TILE + q.lane;
#pragma unroll
    for (int k = 0; k < 5; ++k) dc[i][k] = d[k * P];
  }
}

// (i) sweep 1: s_total per pixel of an active pair
template <int L>
__global__ void __launch_bounds__(Bwd<L>::NT, Bwd<L>::MIN_BLOCKS)
blend_bwd_total(const float* __restrict__ g, const int* __restrict__ counts,
                const int* __restrict__ tids, const int* __restrict__ sblk, int m2b,
                const float* __restrict__ tentry, const float* __restrict__ dout,
                float* __restrict__ total, int T, int C, int tiles_x) {
  constexpr int BT = Bwd<L>::NT, PPT = Bwd<L>::PPT;
  __shared__ float sg[ATTRS][G];
  __shared__ float cut[G];
  Pair<PPT> q;
  bool started;
  const bool active = enter_pair<L>(q, counts, tids, tentry, T, C, tiles_x, started);
  if (!started) return;
  float s_total[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) s_total[i] = 0.0f;
  if (active) {
    const size_t MAX = (size_t)C * G;
    load_chunk<L, BT>(sg, g, q.t, q.c, MAX, L == kRuns ? runs_block(sblk, q.t, q.c, q.count, m2b) : 0, m2b,
                      threadIdx.x);
    float dc[PPT][5];
    load_dc(dc, dout, q);
    __syncthreads();
    stage_cut<BT>(cut, sg);
    const int n = L == kGM ? min(G, q.count - q.c * G) : G;
    float cum[PPT];
    bool alive[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      cum[i] = 0.0f;
      alive[i] = q.t0[i] >= T_EPS;
    }
    for (int j = 0; j < n && any_of(alive); ++j) {
      float dx, dy[PPT], e[PPT], raw[PPT];
      bool hit[PPT];
      if (!test_pixels(sg, cut, j, q, alive, dx, dy, e, raw, hit)) continue;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        // a pixel that misses j adds log1p(-0) = -0 to cum and +0 to s_total
        const float alpha = hit[i] ? fminf(raw[i], ALPHA_MAX) : 0.0f;
        cum[i] = __fadd_rn(cum[i], log1pf(-alpha));
        const float t_in = __fmul_rn(q.t0[i], expf(cum[i]));
        const bool on = hit[i] && t_in >= T_EPS;
        alive[i] = alive[i] && (on || !hit[i]);  // t_in only falls: every later term is 0
        const float w = __fmul_rn(alpha, __fmul_rn(t_in, __frcp_rn(__fsub_rn(1.0f, alpha))));
        const float vdc = value_dot(sg[6][j], sg[7][j], sg[8][j], sg[9][j], dc[i]);
        s_total[i] = __fadd_rn(s_total[i], on ? __fmul_rn(w, vdc) : 0.0f);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i) total[q.base + (q.warp * PPT + i) * TILE + q.lane] = s_total[i];
}

// (ii) the exclusive suffix of every started chunk, last chunk first; reads
// plane 0 (total), writes plane 1 (suffix) of the scratch
__global__ void __launch_bounds__(SUFFIX_NT)
blend_bwd_suffix(const int* __restrict__ counts, const float* __restrict__ total,
                 float* __restrict__ suffix, int T, int C) {
  const long long idx = (long long)blockIdx.x * SUFFIX_NT + threadIdx.x;
  if (idx >= (long long)T * P) return;
  const int t = (int)(idx / P), p = (int)(idx % P);
  const int nc = (int)min((long long)C, ((long long)counts[t] + G - 1) / G);
  const size_t base = (size_t)t * C * P + p;
  float s = 0.0f;
#pragma unroll 8
  for (int c = nc - 1; c >= 0; --c) {
    const float st = total[base + (size_t)c * P];
    suffix[base + (size_t)c * P] = s;
    s = __fadd_rn(s, st);
  }
}

// (iii) sweep 2: per-pair gradients, reduced over the tile in rounds of SUB
template <int L>
__global__ void __launch_bounds__(Bwd<L>::NT, Bwd<L>::MIN_BLOCKS)
blend_bwd(const float* __restrict__ g, const int* __restrict__ counts,
          const int* __restrict__ tids, const int* __restrict__ sblk, int m2b,
          const float* __restrict__ tentry, const float* __restrict__ dout,
          const float* __restrict__ total, const float* __restrict__ suffix,
          float* __restrict__ dg, int T, int C, int tiles_x) {
  constexpr int BT = Bwd<L>::NT, PPT = Bwd<L>::PPT, BW = Bwd<L>::BW;
  __shared__ float sg[ATTRS][G];
  __shared__ float part[BW][SUB][NV];  // per-warp partial sums of one round
  __shared__ int touched[BW][SUB];     // whether the warp's partials were stored
  __shared__ float msum[SUB][NV];      // block sums of one round
  __shared__ float cut[G];
  const int tid = threadIdx.x;
  const size_t MAX = (size_t)C * G;
  Pair<PPT> q;
  bool started;
  if (!enter_pair<L>(q, counts, tids, tentry, T, C, tiles_x, started)) {
    zero_chunk<L>(dg, q.t, q.c, MAX, tid);
    return;
  }
  const int t = q.t, c = q.c;
  const int blk = L == kRuns ? runs_block(sblk, t, c, q.count, m2b) : 0;
  const bool store = L != kRuns || blk < m2b - 1;
  load_chunk<L, BT>(sg, g, t, c, MAX, blk, m2b, tid);
  float dc[PPT][5], s_total[PPT], suf0[PPT], cum[PPT], s_incl[PPT];
  bool alive[PPT];
  load_dc(dc, dout, q);
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const size_t at = q.base + (q.warp * PPT + i) * TILE + q.lane;
    s_total[i] = total[at];
    suf0[i] = suffix[at];
    cum[i] = 0.0f;
    s_incl[i] = 0.0f;
    alive[i] = q.t0[i] >= T_EPS;
  }
  __syncthreads();
  stage_cut<BT>(cut, sg);
  const int n = L == kGM ? min(G, q.count - c * G) : G;

  bool block_alive = true;  // some pixel of the block alive at the round's start
  for (int j0 = 0; j0 < G; j0 += SUB) {
    for (int jj = 0; jj < SUB; ++jj) {
      const int j = j0 + jj;
      float v[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) v[k] = 0.0f;
      bool nz = false;
      float dx, dy[PPT], e[PPT], raw[PPT];
      bool hit[PPT];
      if (block_alive && j < n && test_pixels(sg, cut, j, q, alive, dx, dy, e, raw, hit)) {
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          // a pixel that misses j (alpha 0) leaves cum and s_incl as they are
          // and adds zeros: te, w, draw and dpower are 0
          const float alpha = hit[i] ? fminf(raw[i], ALPHA_MAX) : 0.0f;
          cum[i] = __fadd_rn(cum[i], log1pf(-alpha));
          const float t_in = __fmul_rn(q.t0[i], expf(cum[i]));
          const bool on = hit[i] && t_in >= T_EPS;
          // t_in only falls, so after its first t_in < 1e-4 a pixel's terms
          // are 0 (and s_total - s_incl is exactly 0, its suffix 0)
          alive[i] = alive[i] && (on || !hit[i]);
          const float inv_onem = __frcp_rn(__fsub_rn(1.0f, alpha));
          const float te = on ? __fmul_rn(t_in, inv_onem) : 0.0f;
          const float w = __fmul_rn(alpha, te);
          const float vdc = value_dot(sg[6][j], sg[7][j], sg[8][j], sg[9][j], dc[i]);
          s_incl[i] = __fadd_rn(s_incl[i], __fmul_rn(w, vdc));
          const float suf = __fadd_rn(__fsub_rn(s_total[i], s_incl[i]), suf0[i]);
          const float dalpha = __fsub_rn(__fmul_rn(te, vdc), __fmul_rn(suf, inv_onem));
          // raw >= alpha >= 1/255 where on; at raw >= 0.99 the clamp stops the gradient
          const float draw = on && raw[i] < ALPHA_MAX ? dalpha : 0.0f;
          const float dpower = __fmul_rn(draw, raw[i]);
          if (L == kRuns) {
            v[0] += (sg[2][j] * dx + sg[3][j] * dy[i]) * dpower;
            v[1] += (sg[4][j] * dy[i] + sg[3][j] * dx) * dpower;
            v[2] += -0.5f * dx * dx * dpower;
            v[3] += -dx * dy[i] * dpower;
            v[4] += -0.5f * dy[i] * dy[i] * dpower;
            v[5] += draw * e[i];
          } else {
            const float dpx = dx * dpower;
            const float dpy = dy[i] * dpower;
            v[0] += dpx;
            v[1] += dpy;
            v[2] += dx * dpx;
            v[3] += dy[i] * dpx;
            v[4] += dy[i] * dpy;
            v[5] += dpower;
          }
          v[6] += w * dc[i][0];
          v[7] += w * dc[i][1];
          v[8] += w * dc[i][2];
          v[9] += w * dc[i][3];
          nz |= (w != 0.0f) || (dpower != 0.0f) || (draw != 0.0f);
        }
      }
      const bool any = __any_sync(FULL, nz);
      if (q.lane == 0) touched[q.warp][jj] = any;
      if (any) {
        int id;
        const float sum = reduce_scatter(v, q.lane, id);
        if (id >= 0) part[q.warp][jj][id] = sum;
      }
    }
    block_alive = __syncthreads_or(any_of(alive));
    for (int e = tid; e < SUB * NV; e += BT) {
      const int jj = e / NV, k = e % NV;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < BW; ++w) {
        if (touched[w][jj]) s += part[w][jj][k];
      }
      msum[jj][k] = s;
    }
    __syncthreads();
    // assemble d(mx, my, a, b, c, op, rgb, depth) of the round's Gaussians
    if (store) {
      for (int e = tid; e < SUB * (L == kCM ? PACK_ROWS : NV); e += BT) {
        const int jj = L == kGM ? e / NV : e % SUB;
        const int k = L == kGM ? e % NV : e / SUB;
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
  }
}

// The three launches of one backward call, each checked. scratch: (2, T, C,
// 1024) f32, plane 0 s_total, plane 1 the suffix.
template <int L>
int launch_bwd(const float* g, const int* counts, const int* tids, const int* sblk, int m2b,
               const float* tentry, const float* dout, float* dg, float* scratch, int T, int C,
               int tiles_x, cudaStream_t stream) {
  if (T == 0 || C == 0) return 0;
  const long long pairs = (long long)T * C;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  float* total = scratch;
  float* suffix = scratch + (size_t)pairs * P;
  blend_bwd_total<L><<<(unsigned)pairs, Bwd<L>::NT, 0, stream>>>(g, counts, tids, sblk, m2b, tentry, dout, total,
                                                                T, C, tiles_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned suffix_blocks = (unsigned)(((long long)T * P + SUFFIX_NT - 1) / SUFFIX_NT);
  blend_bwd_suffix<<<suffix_blocks, SUFFIX_NT, 0, stream>>>(counts, total, suffix, T, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blend_bwd<L><<<(unsigned)pairs, Bwd<L>::NT, 0, stream>>>(g, counts, tids, sblk, m2b, tentry, dout, total, suffix,
                                                          dg, T, C, tiles_x);
  return (int)cudaGetLastError();
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
                                  const float* dout, float* dg, float* scratch, int T, int C, int tiles_x,
                                  void* stream) {
  return launch_bwd<kCM>(g, counts, nullptr, nullptr, 0, tentry, dout, dg, scratch, T, C, tiles_x,
                         (cudaStream_t)stream);
}

extern "C" int riggs_blend_bwd_gm_permuted(const float* g, const int* counts, const int* tids,
                                           const float* tentry, const float* dout, float* dg, float* scratch,
                                           int T, int C, int tiles_x, void* stream) {
  return launch_bwd<kGM>(g, counts, tids, nullptr, 0, tentry, dout, dg, scratch, T, C, tiles_x,
                         (cudaStream_t)stream);
}

// dg: (16, m2b * 128), zeroed here on the stream before the launches
extern "C" int riggs_blend_bwd_runs(const float* g, const int* counts, const int* sblk,
                                    const float* tentry, const float* dout, float* dg, float* scratch,
                                    int T, int C, int m2b, int tiles_x, void* stream) {
  cudaError_t err = cudaMemsetAsync(dg, 0, (size_t)PACK_ROWS * m2b * G * sizeof(float), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return launch_bwd<kRuns>(g, counts, nullptr, sblk, m2b, tentry, dout, dg, scratch, T, C, tiles_x,
                           (cudaStream_t)stream);
}
