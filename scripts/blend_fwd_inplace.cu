// The "fwd-inplace" variant of the forward in csrc/blend.cu, for
// scripts/torch_bwd_variants.py: this text replaces the source from the line
// "// Forward: ..." to the backward's section. The same chained launch, but
// with no sums scratch and no combine: an active chunk adds its five sums
// per pixel into out once its tile's previous chunk has added its own (a
// per-tile count of chunks added, polled like the flags), so out = ((0 +
// sums_0) + sums_1) + ..., the shipped combine's order and bits; the tile's
// first chunk writes rows 5-7's zeros, an empty tile's zeros throughout. Its
// scratch is the chain state alone: the ticket, ready[T * C], done[T],
// added[T]. A chunk whose sums are ready before its predecessor's waits,
// holding its SM slot.
// Forward, the chained launch adding each chunk's sums in place (see above).

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

// out rows 0-4 of the thread's pixels += acc, from 0 in the tile's first
// chunk, which also writes rows 5-7's zeros
template <int PPT>
__device__ __forceinline__ void add_sums(float* out, const Pair<PPT>& q, bool first, const float (&acc)[PPT][SUMS]) {
  float* o = out + (size_t)q.t * OUT_ROWS * P + q.warp * PPT * TILE + q.lane;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
#pragma unroll
    for (int k = 0; k < OUT_ROWS; ++k) {
      float* at = o + k * P + i * TILE;
      if (k < SUMS) {
        *at = __fadd_rn(first ? 0.0f : __ldcg(at), acc[i][k]);
      } else if (first) {
        *at = 0.0f;
      }
    }
  }
}

// The one forward launch: each block takes the next (tile, chunk) pair in
// chunk-major order from the ticket, so every pair it waits on has a
// smaller ticket and is already running (no wait can deadlock). state, zeroed
// before the launch: the ticket, ready[T * C] (the pair's t0 is in tentry),
// done[T] (the tile reached its first inactive chunk), added[T] (how many of
// the tile's chunks have added their sums into out).
template <int L>
__global__ void __launch_bounds__(Bwd<L>::NT, FWD_MIN_BLOCKS)
blend_fwd(const float* __restrict__ g, const int* __restrict__ counts, const int* __restrict__ tids,
          const int* __restrict__ sblk, int m2b, float* __restrict__ out, float* __restrict__ tentry,
          int* __restrict__ state, int T, int C, int tiles_x, int tile_offset) {
  constexpr int BT = Bwd<L>::NT, PPT = P / BT;
  __shared__ float sg[ATTRS][G];
  __shared__ float cut[G];
  __shared__ int s_k, s_chain;
  int* ready = state + 1;
  int* done = ready + (size_t)T * C;
  int* added = done + T;
  if (threadIdx.x == 0) s_k = atomicAdd(state, 1);
  __syncthreads();
  Pair<PPT> q;
  const bool started = place_pair<L>(q, s_k, counts, tids, T, C, tiles_x, tile_offset);
  const int t = q.t, c = q.c;
  const int nc = (int)min((long long)C, ((long long)q.count + G - 1) / G);  // started chunks
  float v[PPT];
  if (!started) {
    if (c == 0) {  // an empty tile: nothing blends, every chunk entered at T = 1
      const float zero[PPT][SUMS] = {};
#pragma unroll
      for (int i = 0; i < PPT; ++i) v[i] = 1.0f;
      fill_tentry(tentry, q, 0, C, v);
      add_sums(out, q, true, zero);
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
    if (threadIdx.x == 0) atomicExch(&done[t], 1);
    return;
  }
  if (chain == kReady) blend_rows<true>(sg, cut, n, q, cum, acc);  // cum_end and the sums in one walk
#pragma unroll
  for (int i = 0; i < PPT; ++i) v[i] = __fmul_rn(q.t0[i], expf(cum[i]));  // the next chunk's t0
  if (c + 1 >= nc) {  // the tile's last started chunk: every later one is entered at v
    fill_tentry(tentry, q, c + 1, C, v);
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
  // the sums into out once the previous chunk has added its own: chunk order
  if (threadIdx.x == 0) {
    while (atomicAdd(&added[t], 0) != c) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
  add_sums(out, q, c == 0, acc);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(&added[t], c + 1);
}

// One forward call: the chain state zeroed, then the chained launch, each
// checked. scratch: the chain state, 1 + T * C + 2 * T ints (the first ints
// of the shipped scratch's size).
template <int L>
int launch_fwd(const float* g, const int* counts, const int* tids, const int* sblk, int m2b, float* out,
               float* tentry, void* scratch_, int T, int C, int tiles_x, int tile_offset, cudaStream_t stream) {
  if (T == 0 || C == 0) return 0;
  const long long pairs = (long long)T * C;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int* state = static_cast<int*>(scratch_);
  const cudaError_t err = cudaMemsetAsync(state, 0, (1 + (size_t)pairs + 2 * (size_t)T) * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  blend_fwd<L><<<(unsigned)pairs, Bwd<L>::NT, 0, stream>>>(g, counts, tids, sblk, m2b, out, tentry, state, T, C,
                                                          tiles_x, tile_offset);
  return (int)cudaGetLastError();
}

