// The "split" variant of the forward in csrc/blend.cu, for
// scripts/torch_bwd_variants.py: this text replaces the source from the line
// "// Forward: ..." to the backward's section. Four launches instead of the
// chained one: (i) blend_fwd_cum<L>, grid T x C, every started pair's
// per-pixel cum_end into its own tentry slot; (ii) blend_fwd_scan, a block
// per tile, turns those into tentry in chunk order with the tile-wide skip
// and counts the active chunks; (iii) blend_fwd<L>, grid T x C, each active
// pair's five sums from its own t0 (a pixel dropped after its first
// t_in < 1e-4); (iv) blend_fwd_combine as in the shipped source. The same
// bits as the chained launch; (i) walks every started chunk, the inactive
// ones too. Its scratch (the sums, then T ints) fits in the chained launch's.
// Forward, split into four launches (see above).

constexpr int SCAN_NT = 256;                 // threads per block of the scan
constexpr int SCAN_PPT = P / SCAN_NT;        // pixels per thread, at tid + k * SCAN_NT
constexpr int SCAN_AHEAD = 8;                // chunks whose cum_end the scan loads ahead
constexpr int COMBINE_NT = 256;              // threads per block of the combine

// (i) every started pair's cum_end per pixel, every pixel alive, into its
// own tentry slot
template <int L>
__global__ void __launch_bounds__(Bwd<L>::NT, FWD_MIN_BLOCKS)
blend_fwd_cum(const float* __restrict__ g, const int* __restrict__ counts, const int* __restrict__ tids,
              const int* __restrict__ sblk, int m2b, float* __restrict__ tentry, int T, int C, int tiles_x, int tile_offset) {
  constexpr int BT = Bwd<L>::NT, PPT = P / BT;
  __shared__ float sg[ATTRS][G];
  __shared__ float cut[G];
  Pair<PPT> q;
  if (!place_pair<L>(q, blockIdx.x, counts, tids, T, C, tiles_x, tile_offset)) return;
  load_chunk<L, BT>(sg, g, q.t, q.c, (size_t)C * G, L == kRuns ? runs_block(sblk, q.t, q.c, q.count, m2b) : 0,
                    m2b, threadIdx.x);
  __syncthreads();
  stage_cut<BT>(cut, sg);
  const int n = L == kGM ? min(G, q.count - q.c * G) : G;
  float cum[PPT];
  bool every[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    cum[i] = 0.0f;
    every[i] = true;
  }
  for (int j = 0; j < n; ++j) {
    float dx, dy[PPT], e[PPT], raw[PPT];
    bool hit[PPT];
    if (!test_pixels(sg, cut, j, q, every, dx, dy, e, raw, hit)) continue;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      // a pixel that misses j adds log1p(-0) = -0: cum keeps its bits
      const float alpha = hit[i] ? fminf(raw[i], ALPHA_MAX) : 0.0f;
      cum[i] = __fadd_rn(cum[i], log1pf(-alpha));
    }
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i) tentry[q.base + (q.warp * PPT + i) * TILE + q.lane] = cum[i];
}

// (ii) per tile, in chunk order: tentry[c] = t0 and, while the chunk is
// active, t0 = t0 * exp(cum_end[c]) (cum_end read from the same slot first);
// nact[t] = the number of active chunks
__global__ void __launch_bounds__(SCAN_NT)
blend_fwd_scan(const int* __restrict__ counts, float* __restrict__ tentry, int* __restrict__ nact, int C) {
  const int t = blockIdx.x;
  const int nc = (int)min((long long)C, ((long long)counts[t] + G - 1) / G);  // started chunks
  float* te = tentry + (size_t)t * C * P + threadIdx.x;
  float trun[SCAN_PPT];
#pragma unroll
  for (int k = 0; k < SCAN_PPT; ++k) trun[k] = 1.0f;
  int c = 0;
  bool live = true;  // uniform: some pixel of the tile has trun >= 1e-4
  while (live && c < nc) {
    float cum[SCAN_AHEAD][SCAN_PPT];
#pragma unroll
    for (int b = 0; b < SCAN_AHEAD; ++b) {
#pragma unroll
      for (int k = 0; k < SCAN_PPT; ++k) cum[b][k] = c + b < nc ? te[(size_t)(c + b) * P + k * SCAN_NT] : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < SCAN_AHEAD; ++b) {
      if (c >= nc) break;
      bool any = false;
#pragma unroll
      for (int k = 0; k < SCAN_PPT; ++k) any |= trun[k] >= T_EPS;
      live = __syncthreads_or(any);
      if (!live) break;
#pragma unroll
      for (int k = 0; k < SCAN_PPT; ++k) {
        te[(size_t)c * P + k * SCAN_NT] = trun[k];
        trun[k] = __fmul_rn(trun[k], expf(cum[b][k]));
      }
      ++c;
    }
  }
  if (threadIdx.x == 0) nact[t] = c;
  for (; c < C; ++c) {  // skipped chunks: the t0 they would enter with
#pragma unroll
    for (int k = 0; k < SCAN_PPT; ++k) te[(size_t)c * P + k * SCAN_NT] = trun[k];
  }
}

// (iii) an active pair's weighted sums per pixel from its own t0, into
// part (T, C, SUMS, P); inactive pairs write nothing
template <int L>
__global__ void __launch_bounds__(Bwd<L>::NT, FWD_MIN_BLOCKS)
blend_fwd(const float* __restrict__ g, const int* __restrict__ counts, const int* __restrict__ tids,
          const int* __restrict__ sblk, int m2b, const float* __restrict__ tentry, float* __restrict__ part,
          int T, int C, int tiles_x, int tile_offset) {
  constexpr int BT = Bwd<L>::NT, PPT = P / BT;
  __shared__ float sg[ATTRS][G];
  __shared__ float cut[G];
  Pair<PPT> q;
  bool started;
  if (!enter_pair<L>(q, counts, tids, tentry, T, C, tiles_x, tile_offset, started)) return;
  load_chunk<L, BT>(sg, g, q.t, q.c, (size_t)C * G, L == kRuns ? runs_block(sblk, q.t, q.c, q.count, m2b) : 0,
                    m2b, threadIdx.x);
  __syncthreads();
  stage_cut<BT>(cut, sg);
  const int n = L == kGM ? min(G, q.count - q.c * G) : G;
  float cum[PPT], acc[PPT][SUMS];
  bool alive[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    cum[i] = 0.0f;
    alive[i] = q.t0[i] >= T_EPS;
#pragma unroll
    for (int k = 0; k < SUMS; ++k) acc[i][k] = 0.0f;
  }
  for (int j = 0; j < n && any_of(alive); ++j) {
    float dx, dy[PPT], e[PPT], raw[PPT];
    bool hit[PPT];
    if (!test_pixels(sg, cut, j, q, alive, dx, dy, e, raw, hit)) continue;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      // a pixel that misses j (alpha 0) leaves cum as it is and adds w = 0
      const float alpha = hit[i] ? fminf(raw[i], ALPHA_MAX) : 0.0f;
      cum[i] = __fadd_rn(cum[i], log1pf(-alpha));
      const float t_in = __fmul_rn(q.t0[i], expf(cum[i]));
      const bool on = hit[i] && t_in >= T_EPS;
      alive[i] = alive[i] && (on || !hit[i]);  // t_in only falls: every later weight is 0
      const float w = on ? __fmul_rn(alpha, __fdiv_rn(t_in, __fsub_rn(1.0f, alpha))) : 0.0f;
      acc[i][0] += w * sg[6][j];
      acc[i][1] += w * sg[7][j];
      acc[i][2] += w * sg[8][j];
      acc[i][3] += w * sg[9][j];
      acc[i][4] += w;
    }
  }
  float* o = part + q.base * SUMS;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
#pragma unroll
    for (int k = 0; k < SUMS; ++k) o[k * P + (q.warp * PPT + i) * TILE + q.lane] = acc[i][k];
  }
}

// (iv) out = the tile's active chunks' sums in chunk order; rows 5-7 zero
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

// The four launches of one forward call, each checked. scratch: the
// (T, C, SUMS, P) f32 sums, then T ints (nact).
template <int L>
int launch_fwd(const float* g, const int* counts, const int* tids, const int* sblk, int m2b, float* out,
               float* tentry, void* scratch, int T, int C, int tiles_x, int tile_offset, cudaStream_t stream) {
  if (T == 0 || C == 0) return 0;
  const long long pairs = (long long)T * C;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(scratch);
  int* nact = reinterpret_cast<int*>(part + (size_t)pairs * SUMS * P);
  blend_fwd_cum<L><<<(unsigned)pairs, Bwd<L>::NT, 0, stream>>>(g, counts, tids, sblk, m2b, tentry, T, C, tiles_x, tile_offset);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blend_fwd_scan<<<(unsigned)T, SCAN_NT, 0, stream>>>(counts, tentry, nact, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blend_fwd<L><<<(unsigned)pairs, Bwd<L>::NT, 0, stream>>>(g, counts, tids, sblk, m2b, tentry, part, T, C,
                                                          tiles_x, tile_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned combine_blocks = (unsigned)(((long long)T * P + COMBINE_NT - 1) / COMBINE_NT);
  blend_fwd_combine<<<combine_blocks, COMBINE_NT, 0, stream>>>(part, nact, out, T, C);
  return (int)cudaGetLastError();
}

