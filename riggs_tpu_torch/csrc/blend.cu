// Fused per-tile front-to-back Gaussian blend, forward only, for Hopper (sm_90a).
//
// Replaces the two forward Pallas kernels of riggs_tpu/render/pallas_blend.py:
//   riggs_blend_fwd_cm          <- _fwd_kernel      (:179, entry pallas_blend)
//   riggs_blend_fwd_gm_permuted <- _fwd_kernel_gm   (:602, entry pallas_blend_permuted_gm)
// One template gives both; each instantiation is its own kernel.
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

// GM = false: g is (T, 16, MAX) channel-major, tile t renders tile t, every
//             row of an active chunk is blended (the caller masked opacity).
// GM = true:  g is (T, MAX, 10) gaussian-major, tile t renders tids[t], rows
//             at or past counts[t] are masked.
template <bool GM>
__global__ void __launch_bounds__(P)
blend_fwd(const float* __restrict__ g, const int* __restrict__ counts,
          const int* __restrict__ tids, float* __restrict__ out,
          float* __restrict__ tentry, int C, int tiles_x) {
  __shared__ float sg[ATTRS][G];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int tile = GM ? tids[t] : t;
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

    for (int k = p; k < ATTRS * G; k += P) {
      if (GM) {
        sg[k % ATTRS][k / ATTRS] = g[((size_t)t * MAX + (size_t)c * G) * ATTRS + k];
      } else {
        sg[k / G][k % G] = g[((size_t)t * PACK_ROWS + k / G) * MAX + (size_t)c * G + k % G];
      }
    }
    __syncthreads();

    const int n = GM ? min(G, count - c * G) : G;
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

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; stream is a
// cudaStream_t. Returns the launch's cudaError_t (0 on success).
extern "C" int riggs_blend_fwd_cm(const float* g, const int* counts, float* out,
                                  float* tentry, int T, int C, int tiles_x,
                                  void* stream) {
  blend_fwd<false><<<T, P, 0, (cudaStream_t)stream>>>(g, counts, nullptr, out, tentry, C, tiles_x);
  return (int)cudaGetLastError();
}

extern "C" int riggs_blend_fwd_gm_permuted(const float* g, const int* counts,
                                           const int* tids, float* out, float* tentry,
                                           int T, int C, int tiles_x, void* stream) {
  blend_fwd<true><<<T, P, 0, (cudaStream_t)stream>>>(g, counts, tids, out, tentry, C, tiles_x);
  return (int)cudaGetLastError();
}
