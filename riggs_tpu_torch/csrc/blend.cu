// Fused per-tile front-to-back Gaussian blend and its backward, for Hopper (sm_90a).
//
// Replaces the three forward Pallas kernels of riggs_tpu/render/pallas_blend.py:
//   riggs_blend_fwd_cm          <- _fwd_kernel      (:179, entry pallas_blend)
//   riggs_blend_fwd_gm_permuted <- _fwd_kernel_gm   (:602, entry pallas_blend_permuted_gm)
//   riggs_blend_fwd_runs        <- _fwd_kernel_runs (:347, entry pallas_blend_runs)
// (riggs_blend_fwd_cm and riggs_blend_bwd_cm take a global tile offset, which
// makes them the entry pallas_blend_offset (:955) too: a shard of the tiles);
// and, below the forward, their three backward kernels. One template, over the
// layout of the attribute rows, gives all three of each; each instantiation
// is its own kernel.
//
// Forward math (per pixel, for the rows j of a chunk in blend order):
//   alpha_j = min(op_j * exp(power_j), 0.99), 0 where power_j > 0 or alpha_j < 1/255
//   cum_j   = sum over i <= j of log1p(-alpha_i),   t_in_j = t0 * exp(cum_j)
//   w_j     = alpha_j * t_in_j / (1 - alpha_j) * [t_in_j >= 1e-4]
//   out    += [rgb, depth, 1]_j * w_j,   and the next chunk's t0 = t0 * exp(cum_end)
// A (tile, chunk) pair is active when the chunk starts before the tile's
// count and some pixel of the tile enters it with t0 >= 1e-4 (monotone: the
// active chunks are a prefix of the tile's); a skipped chunk leaves t0 as it
// is. tentry holds every chunk's t0, skipped chunks' too.
//
// Forward decomposition. The TPU walked each tile's chunks in order on a
// sequential grid and carried t0 in VMEM. A chunk's cum_end does not depend
// on its t0 (only the weights and the 1e-4 test do), so here every
// (tile, chunk) pair is a block of its own, and only t0 is passed from one
// chunk to the next. One C entry zeroes a small chain state and makes two
// launches on the stream:
//   blend_fwd<L>, T x C blocks: each takes the next pair in chunk-major
//     order from an atomic ticket, so every pair it waits on holds a smaller
//     ticket and is already running (no wait can deadlock), and every tile's
//     first chunk, the heaviest, goes first. Chunk 0 starts from t0 = 1. A
//     later chunk looks at its tile's state:
//       done:    the tile reached its first inactive chunk: nothing to do;
//       ready:   the previous chunk has published this chunk's t0 in tentry:
//                one walk over the rows gives cum_end (every pixel) and the
//                weighted sums;
//       pending: it sums cum_end first (every pixel, no t0), then waits for
//                the t0, publishes the next t0 at once, then walks the rows
//                again for the weighted sums, a pixel dropped after its first
//                t_in < 1e-4.
//     A chunk with t0 known and no pixel >= 1e-4 is the tile's first
//     inactive one: it writes its t0 as every later chunk's tentry and marks
//     the tile done. An active chunk publishes __fmul_rn(t0, expf(cum_end))
//     as the next chunk's tentry (stores, __threadfence, then a flag), or,
//     as the last started chunk, as every later chunk's. The first inactive
//     or last started chunk records the tile's count of active chunks. An
//     active chunk writes its five sums per pixel into a (T, C, 5, 1024) f32
//     scratch (only the active chunks' sums are written: ~4% of it at
//     800x800, where it holds 0.5-0.8 GB a call).
//   blend_fwd_combine, a thread per (tile, pixel): out = the active chunks'
//     sums added in chunk order (the plain version's order), rows 5-7 zero.
// tentry keeps the bits of a block per tile walking its chunks: cum is
// summed with __fadd_rn in row order per pixel and t0 chained in chunk
// order, so the active set is the same too. out moves in its last bits only
// (per-chunk sums added over chunks, for one running sum). The only atomics
// are the integer ticket and flags, and both paths give every weight the
// same bits (a dropped pixel adds exact zeros): a second launch gives the
// same bits whichever chunks were pending. What the chain costs: a pending
// chunk walks its rows twice, and one that turns out inactive once for
// nothing. scripts/torch_bwd_variants.py keeps the alternatives measured
// against it: "fwd-inplace", no sums scratch and no combine, each chunk
// adding its sums into out after its predecessor's (the same bits; as fast
// on plain windows, 0.07 ms slower over a ladder step's four calls on an
// H100: in the deep buckets a chunk waiting for its predecessor's add holds
// its SM slot); "split", separate launches (every started chunk's cum_end,
// a scan per tile, the active chunks' sums), 0.11-0.14 ms slower a call;
// "fwd-wait", a pending chunk waiting before it walks (about 3x slower:
// each tile's chunks run one after another again); "fwd-abort", a pending
// chunk stopping its cum walk once the tile is done (the checks cost more
// than they save); "fwd-scale", a pending chunk walking once as if t0 were
// 1 and scaling its sums by t0 (slower, and its out bits depend on which
// chunks were pending).
//
// Blocks: Bwd<L>'s thread counts (see Blocks under the backward; the
// forward at 256 threads for kGM lost 0.25 ms over a ladder step's four
// calls, and 512 threads for every layout, or four blocks an SM, gained
// nothing), FWD_MIN_BLOCKS blocks an SM; each thread PPT pixels of one
// column with branch-free steps over them so that their exp / log1p chains
// overlap, the per-Gaussian power cut, the same device code (Pair,
// load_chunk, test_pixels, stage_cut). Thread 0 takes the ticket and waits
// (polling the flags with __nanosleep).
//
// What bounds it on an H100: per (Gaussian, pixel) pair the blend needs the
// EWA power and the alpha test, and per hit the transmittance update and the
// accumulation, ~30 FP32 instructions and three special-function operations
// (exp of the EWA power, log1p, exp of the log-sum) against ~40 bytes per
// Gaussian row and 4 bytes per pixel and chunk of tentry: operation-bound by
// two orders of magnitude (chip_smoke.py's _bound). The design spends some
// operations more than the function needs (pending chunks' second walk) to
// use the whole card at once, where one block per tile left the deep tiles
// serial on a few SMs.
//
// The EWA power and alpha are computed with explicit round-to-nearest
// intrinsics, in the plain version's operation order, so that no fused
// multiply-add moves a value across the 1/255 or 1e-4 thresholds relative
// to that version.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int P = TILE * TILE;  // pixels per tile
constexpr int G = 128;          // Gaussians per chunk
constexpr int ATTRS = 10;       // mx, my, conic a b c, opacity, rgb, depth
constexpr int PACK_ROWS = 16;   // channel-major row stride
constexpr int OUT_ROWS = 8;     // rgb, depth, acc, 3 zero rows
constexpr int SUMS = 5;         // per-pixel forward sums: rgb, depth, acc
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

// The shape of a block of the per-pair kernels, by layout: NT threads of PPT
// pixels each, one column (rows warp * PPT + i), BW warps, and at least
// MIN_BLOCKS blocks held by an SM (which caps registers per thread). The
// backward's choice is explained under Blocks below; the forward takes the
// same thread counts and asks for FWD_MIN_BLOCKS blocks per SM.
template <int L>
struct Bwd {
  static constexpr int NT = L == kGM ? 512 : 256;
  static constexpr int PPT = P / NT;
  static constexpr int BW = NT / 32;
  static constexpr int MIN_BLOCKS = L == kGM ? 1 : 2;
};
constexpr int FWD_MIN_BLOCKS = 2;
// a power below log(1/255 / opacity) - CUT leaves alpha below 1/255 whatever
// the rounding of expf and the product (errors ~1e-6 in the log)
constexpr float CUT = 1e-3f;

// What the per-pair kernels share: the pair's place, its pixels and their
// entry transmittance.
template <int PPT>
struct Pair {
  int t, c, count, lane, warp;
  float px, py0;
  float t0[PPT];
  size_t base;  // (t * C + c) * P: the pair's offset in tentry and in each scratch plane
};

// The block's (tile, chunk) pair, number k in chunk-major order, and its
// pixels' place; returns whether the chunk starts before the tile's count
// (uniform over the block). Local tile t of kCM and kRuns renders the image's
// tile t + tile_offset (the global tile of a shard's first row, as in
// pallas_blend_offset; 0 for kRuns and a whole image), tile t of kGM renders
// tids[t].
template <int L, int PPT>
__device__ __forceinline__ bool place_pair(Pair<PPT>& q, int k, const int* __restrict__ counts,
                                           const int* __restrict__ tids, int T, int C, int tiles_x,
                                           int tile_offset) {
  // chunk-major: the blocks of every tile's first chunk, the heaviest (all
  // its pixels enter live), are dispatched first
  q.c = k / T;
  q.t = k - q.c * T;
  q.count = counts[q.t];
  q.lane = threadIdx.x & 31;
  q.warp = threadIdx.x >> 5;
  q.base = ((size_t)q.t * C + q.c) * P;
  if (q.c * G >= q.count) return false;
  const int tile = L == kGM ? tids[q.t] : q.t + tile_offset;
  q.px = (float)((tile % tiles_x) * TILE + q.lane);
  q.py0 = (float)((tile / tiles_x) * TILE + q.warp * PPT);
  return true;
}

// place_pair, then the pixels' entry transmittance (tentry is read only for
// started chunks); returns whether the pair is active (uniform).
template <int L, int PPT>
__device__ __forceinline__ bool enter_pair(Pair<PPT>& q, const int* __restrict__ counts,
                                           const int* __restrict__ tids, const float* __restrict__ tentry, int T,
                                           int C, int tiles_x, int tile_offset, bool& started) {
  started = place_pair<L>(q, blockIdx.x, counts, tids, T, C, tiles_x, tile_offset);
  if (!started) return false;
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

// ---------------------------------------------------------------------------
// Forward: the chained launch and the combine of the design at the top of
// the file.

constexpr int COMBINE_NT = 256;  // threads per block of the combine
enum Chain : int { kPending, kReady, kDone };

// The weighted sums of rows [0, n) for the thread's pixels from their entry
// transmittance q.t0, added into acc, with cum summed from 0. With FULL_CUM
// every pixel's cum runs over all n rows (cum_end on return, for the next
// chunk's t0); else a pixel is dropped after its first t_in < 1e-4 (t_in
// only falls, so every later weight of it is 0) and the loop ends with the
// last live pixel.
template <bool FULL_CUM, int PPT>
__device__ __forceinline__ void blend_rows(const float (*sg)[G], const float* cut, int n, const Pair<PPT>& q,
                                           float (&cum)[PPT], float (&acc)[PPT][SUMS]) {
  bool alive[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) alive[i] = FULL_CUM || q.t0[i] >= T_EPS;
  for (int j = 0; j < n && (FULL_CUM || any_of(alive)); ++j) {
    float dx, dy[PPT], e[PPT], raw[PPT];
    bool hit[PPT];
    if (!test_pixels(sg, cut, j, q, alive, dx, dy, e, raw, hit)) continue;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      // a pixel that misses j (alpha 0) adds log1p(-0) = -0 to cum, keeping
      // its bits, and w = 0
      const float alpha = hit[i] ? fminf(raw[i], ALPHA_MAX) : 0.0f;
      cum[i] = __fadd_rn(cum[i], log1pf(-alpha));
      const float t_in = __fmul_rn(q.t0[i], expf(cum[i]));
      const bool on = hit[i] && t_in >= T_EPS;
      if (!FULL_CUM) alive[i] = alive[i] && (on || !hit[i]);
      const float w = on ? __fmul_rn(alpha, __fdiv_rn(t_in, __fsub_rn(1.0f, alpha))) : 0.0f;
      acc[i][0] += w * sg[6][j];
      acc[i][1] += w * sg[7][j];
      acc[i][2] += w * sg[8][j];
      acc[i][3] += w * sg[9][j];
      acc[i][4] += w;
    }
  }
}

// cum_end of rows [0, n) for the thread's pixels, every pixel alive (no t0)
template <int PPT>
__device__ __forceinline__ void cum_rows(const float (*sg)[G], const float* cut, int n, const Pair<PPT>& q,
                                         float (&cum)[PPT]) {
  bool every[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) every[i] = true;
  for (int j = 0; j < n; ++j) {
    float dx, dy[PPT], e[PPT], raw[PPT];
    bool hit[PPT];
    if (!test_pixels(sg, cut, j, q, every, dx, dy, e, raw, hit)) continue;
#pragma unroll
    for (int i = 0; i < PPT; ++i) cum[i] = __fadd_rn(cum[i], log1pf(-(hit[i] ? fminf(raw[i], ALPHA_MAX) : 0.0f)));
  }
}

// tentry of chunks [c0, C) of the pair's tile = v (per pixel)
template <int PPT>
__device__ __forceinline__ void fill_tentry(float* tentry, const Pair<PPT>& q, int c0, int C, const float (&v)[PPT]) {
  float* te = tentry + (size_t)q.t * C * P + q.warp * PPT * TILE + q.lane;
  for (int c = c0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) te[(size_t)c * P + i * TILE] = v[i];
  }
}

// The one forward launch: each block takes the next (tile, chunk) pair in
// chunk-major order from the ticket, so every pair it waits on has a
// smaller ticket and is already running (no wait can deadlock). state:
// the ticket, ready[T * C] (the pair's t0 is in tentry), done[T] (the tile
// reached its first inactive chunk), zeroed before the launch; then nact[T].
template <int L>
__global__ void __launch_bounds__(Bwd<L>::NT, FWD_MIN_BLOCKS)
blend_fwd(const float* __restrict__ g, const int* __restrict__ counts, const int* __restrict__ tids,
          const int* __restrict__ sblk, int m2b, float* __restrict__ tentry, float* __restrict__ part,
          int* __restrict__ state, int T, int C, int tiles_x, int tile_offset) {
  constexpr int BT = Bwd<L>::NT, PPT = P / BT;
  __shared__ float sg[ATTRS][G];
  __shared__ float cut[G];
  __shared__ int s_k, s_chain;
  int* ready = state + 1;
  int* done = ready + (size_t)T * C;
  int* nact = done + T;
  if (threadIdx.x == 0) s_k = atomicAdd(state, 1);
  __syncthreads();
  Pair<PPT> q;
  const bool started = place_pair<L>(q, s_k, counts, tids, T, C, tiles_x, tile_offset);
  const int t = q.t, c = q.c;
  const int nc = (int)min((long long)C, ((long long)q.count + G - 1) / G);  // started chunks
  float v[PPT];
  if (!started) {
    if (c == 0) {  // an empty tile: nothing blends, every chunk entered at T = 1
#pragma unroll
      for (int i = 0; i < PPT; ++i) v[i] = 1.0f;
      fill_tentry(tentry, q, 0, C, v);
      if (threadIdx.x == 0) nact[t] = 0;
    }
    return;
  }
  // t0 known now: chunk 0 (T = 1), or the previous chunk has published
  if (threadIdx.x == 0) {
    s_chain = c == 0 ? kReady : atomicAdd(&done[t], 0) ? kDone : atomicAdd(&ready[(size_t)t * C + c], 0) ? kReady
                                                                                                     : kPending;
    __threadfence();  // acquire: what the previous chunk published is seen before the block reads it
  }
  __syncthreads();
  const int chain = s_chain;
  if (chain == kDone) return;
  load_chunk<L, BT>(sg, g, t, c, (size_t)C * G, L == kRuns ? runs_block(sblk, t, c, q.count, m2b) : 0, m2b,
                    threadIdx.x);
  __syncthreads();
  stage_cut<BT>(cut, sg);
  const int n = L == kGM ? min(G, q.count - c * G) : G;
  float cum[PPT], acc[PPT][SUMS];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    cum[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < SUMS; ++k) acc[i][k] = 0.0f;
  }
  if (chain == kPending) {
    // sum cum_end while the previous chunk runs, then wait for its t0
    cum_rows(sg, cut, n, q, cum);
    if (threadIdx.x == 0) {
      while (true) {
        if (atomicAdd(&done[t], 0)) { s_chain = kDone; break; }
        if (atomicAdd(&ready[(size_t)t * C + c], 0)) { s_chain = kReady; break; }
        __nanosleep(64);
      }
      __threadfence();
    }
    __syncthreads();
    if (s_chain == kDone) return;
  }
  bool live = false;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    float* te = tentry + q.base + (q.warp * PPT + i) * TILE + q.lane;
    if (c == 0) *te = 1.0f;
    q.t0[i] = c == 0 ? 1.0f : __ldcg(te);
    live |= q.t0[i] >= T_EPS;
  }
  if (!__syncthreads_or(live)) {
    // the tile's first inactive chunk: it and every later chunk keep t0
    fill_tentry(tentry, q, c + 1, C, q.t0);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      nact[t] = c;
      atomicExch(&done[t], 1);
    }
    return;
  }
  if (chain == kReady) blend_rows<true>(sg, cut, n, q, cum, acc);  // cum_end and the sums in one walk
#pragma unroll
  for (int i = 0; i < PPT; ++i) v[i] = __fmul_rn(q.t0[i], expf(cum[i]));  // the next chunk's t0
  if (c + 1 >= nc) {  // the tile's last started chunk: every later one is entered at v
    fill_tentry(tentry, q, c + 1, C, v);
    if (threadIdx.x == 0) nact[t] = nc;
  } else {
#pragma unroll
    for (int i = 0; i < PPT; ++i) tentry[q.base + P + (q.warp * PPT + i) * TILE + q.lane] = v[i];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicExch(&ready[(size_t)t * C + c + 1], 1);
  }
  if (chain == kPending) {  // published first: now the sums from t0
#pragma unroll
    for (int i = 0; i < PPT; ++i) cum[i] = 0.0f;
    blend_rows<false>(sg, cut, n, q, cum, acc);
  }
  float* o = part + q.base * SUMS;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
#pragma unroll
    for (int k = 0; k < SUMS; ++k) o[k * P + (q.warp * PPT + i) * TILE + q.lane] = acc[i][k];
  }
}

// out = the tile's active chunks' sums in chunk order; rows 5-7 zero
__global__ void __launch_bounds__(COMBINE_NT)
blend_fwd_combine(const float* __restrict__ part, const int* __restrict__ nact, float* __restrict__ out, int T,
                  int C) {
  const long long idx = (long long)blockIdx.x * COMBINE_NT + threadIdx.x;
  if (idx >= (long long)T * P) return;
  const int t = (int)(idx / P), p = (int)(idx % P);
  const int na = nact[t];
  const float* s = part + (size_t)t * C * SUMS * P + p;
  float sum[SUMS];
#pragma unroll
  for (int k = 0; k < SUMS; ++k) sum[k] = 0.0f;
  for (int c = 0; c < na; ++c) {
#pragma unroll
    for (int k = 0; k < SUMS; ++k) sum[k] = __fadd_rn(sum[k], s[((size_t)c * SUMS + k) * P]);
  }
  float* o = out + (size_t)t * OUT_ROWS * P + p;
#pragma unroll
  for (int k = 0; k < OUT_ROWS; ++k) o[k * P] = k < SUMS ? sum[k] : 0.0f;
}

// One forward call: the chain state zeroed, the chained launch, the
// combine, each checked. scratch: the (T, C, SUMS, P) f32 sums, then the
// chain state (1 + T * C + T ints, zeroed here) and nact (T ints).
template <int L>
int launch_fwd(const float* g, const int* counts, const int* tids, const int* sblk, int m2b, float* out,
               float* tentry, void* scratch, int T, int C, int tiles_x, int tile_offset, cudaStream_t stream) {
  if (T == 0 || C == 0) return 0;
  const long long pairs = (long long)T * C;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(scratch);
  int* state = reinterpret_cast<int*>(part + (size_t)pairs * SUMS * P);
  cudaError_t err = cudaMemsetAsync(state, 0, (1 + (size_t)pairs + T) * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  blend_fwd<L><<<(unsigned)pairs, Bwd<L>::NT, 0, stream>>>(g, counts, tids, sblk, m2b, tentry, part, state, T, C,
                                                          tiles_x, tile_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int* nact = state + 1 + pairs + T;
  const unsigned combine_blocks = (unsigned)(((long long)T * P + COMBINE_NT - 1) / COMBINE_NT);
  blend_fwd_combine<<<combine_blocks, COMBINE_NT, 0, stream>>>(part, nact, out, T, C);
  return (int)cudaGetLastError();
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

constexpr int SUFFIX_NT = 256;  // threads per block of the suffix pass
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
                float* __restrict__ total, int T, int C, int tiles_x, int tile_offset) {
  constexpr int BT = Bwd<L>::NT, PPT = Bwd<L>::PPT;
  __shared__ float sg[ATTRS][G];
  __shared__ float cut[G];
  Pair<PPT> q;
  bool started;
  const bool active = enter_pair<L>(q, counts, tids, tentry, T, C, tiles_x, tile_offset, started);
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
          float* __restrict__ dg, int T, int C, int tiles_x, int tile_offset) {
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
  if (!enter_pair<L>(q, counts, tids, tentry, T, C, tiles_x, tile_offset, started)) {
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
               int tiles_x, int tile_offset, cudaStream_t stream) {
  if (T == 0 || C == 0) return 0;
  const long long pairs = (long long)T * C;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  float* total = scratch;
  float* suffix = scratch + (size_t)pairs * P;
  blend_bwd_total<L><<<(unsigned)pairs, Bwd<L>::NT, 0, stream>>>(g, counts, tids, sblk, m2b, tentry, dout, total,
                                                                T, C, tiles_x, tile_offset);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned suffix_blocks = (unsigned)(((long long)T * P + SUFFIX_NT - 1) / SUFFIX_NT);
  blend_bwd_suffix<<<suffix_blocks, SUFFIX_NT, 0, stream>>>(counts, total, suffix, T, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blend_bwd<L><<<(unsigned)pairs, Bwd<L>::NT, 0, stream>>>(g, counts, tids, sblk, m2b, tentry, dout, total, suffix,
                                                          dg, T, C, tiles_x, tile_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; stream is a
// cudaStream_t. Returns the first failed launch's cudaError_t (0 on success).
// The forward's scratch: the (T, C, 5, 1024) f32 sums, then 1 + T * C + T ints
// of chain state (the ticket, ready, done; zeroed here on the stream) and T
// ints of nact.
// Local tile t renders the image's tile t + tile_offset (0 but for a shard).
extern "C" int riggs_blend_fwd_cm(const float* g, const int* counts, float* out, float* tentry, void* scratch,
                                  int T, int C, int tiles_x, int tile_offset, void* stream) {
  return launch_fwd<kCM>(g, counts, nullptr, nullptr, 0, out, tentry, scratch, T, C, tiles_x, tile_offset,
                         (cudaStream_t)stream);
}

extern "C" int riggs_blend_fwd_gm_permuted(const float* g, const int* counts, const int* tids, float* out,
                                           float* tentry, void* scratch, int T, int C, int tiles_x,
                                           void* stream) {
  return launch_fwd<kGM>(g, counts, tids, nullptr, 0, out, tentry, scratch, T, C, tiles_x, 0,
                         (cudaStream_t)stream);
}

// g: (16, m2b * 128); counts, sblk: (T,); C chunks per tile
extern "C" int riggs_blend_fwd_runs(const float* g, const int* counts, const int* sblk, float* out, float* tentry,
                                    void* scratch, int T, int C, int m2b, int tiles_x, void* stream) {
  return launch_fwd<kRuns>(g, counts, nullptr, sblk, m2b, out, tentry, scratch, T, C, tiles_x, 0,
                           (cudaStream_t)stream);
}

// the forward's tile_offset, in all three launches
extern "C" int riggs_blend_bwd_cm(const float* g, const int* counts, const float* tentry,
                                  const float* dout, float* dg, float* scratch, int T, int C, int tiles_x,
                                  int tile_offset, void* stream) {
  return launch_bwd<kCM>(g, counts, nullptr, nullptr, 0, tentry, dout, dg, scratch, T, C, tiles_x, tile_offset,
                         (cudaStream_t)stream);
}

extern "C" int riggs_blend_bwd_gm_permuted(const float* g, const int* counts, const int* tids,
                                           const float* tentry, const float* dout, float* dg, float* scratch,
                                           int T, int C, int tiles_x, void* stream) {
  return launch_bwd<kGM>(g, counts, tids, nullptr, 0, tentry, dout, dg, scratch, T, C, tiles_x, 0,
                         (cudaStream_t)stream);
}

// dg: (16, m2b * 128), zeroed here on the stream before the launches
extern "C" int riggs_blend_bwd_runs(const float* g, const int* counts, const int* sblk,
                                    const float* tentry, const float* dout, float* dg, float* scratch,
                                    int T, int C, int m2b, int tiles_x, void* stream) {
  cudaError_t err = cudaMemsetAsync(dg, 0, (size_t)PACK_ROWS * m2b * G * sizeof(float), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return launch_bwd<kRuns>(g, counts, nullptr, sblk, m2b, tentry, dout, dg, scratch, T, C, tiles_x, 0,
                           (cudaStream_t)stream);
}
