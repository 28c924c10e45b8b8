// Batched best-fit rotations for Hopper (sm_90a): the kernels behind
// riggs_tpu_torch/ops/arap.py:estimate_rotations (the fused entry, which
// builds each node's covariance from its edges) and
// riggs_tpu_torch/ops/geometry.py:fit_rotations (the covariance entry).
//
// Replaces no Pallas kernel: riggs_tpu/ops/arap.py:estimate_rotations is
// stock gathers and an einsum, and riggs_tpu/ops/geometry.py:fit_rotations
// a stock jnp.linalg.svd that XLA lowers. Their torch counterpart on the
// card, torch.linalg.svd, checks its convergence flags on the host (two
// blocking reads a call, one call a stage-1 step in the ARAP loss). These
// kernels read nothing back.
//
// The fit. For each f32 matrix cov = U S V^T it writes R = U diag(1, 1,
// det(U V^T)) V^T, the proper rotation that maximizes trace(R^T cov), all in
// f64 registers:
//   1. cov is scaled by its largest |entry| (the identity if that is 0);
//      A = cov^T cov;
//   2. cyclic Jacobi sweeps over (0,1), (0,2), (1,2) diagonalize A: its
//      eigenvectors V and eigenvalues S^2, sorted descending (a sorting
//      network, stable on ties). Each rotation is built from one
//      reciprocal and two rsqrt: with d = |a_qq - a_pp|, h = sqrt(d^2 +
//      4 a_pq^2) = q rsqrt(q), t = 2 a_pq sign / (d + h) and, since 1 + t^2
//      = 2h / (d + h), c = rsqrt(2h / (d + h)), s = t c (no cancellation:
//      d + h >= h > 0). The sweeps stop once the off-diagonal of A, sum
//      a_pq^2, is at most (ROTFIT_OFF trace A)^2, checked before each
//      sweep, or after ROTFIT_SWEEPS = 8. Jacobi converges quadratically
//      on a 3x3: the off-diagonal left at the stop is far below what moves
//      R by f32 rounding (R depends on V through directions that a residual
//      of 1e-12 trace A tilts by about that over the eigengap, and where
//      the gap closes R does not depend on the basis of the pair). On the
//      stage-1 ARAP fits that chip_smoke.py records ([stage1], [loop],
//      [flow], [zju]: 512-673 nodes a fit, K = 10) the sweeps ran 2, 3 or
//      4 times, 3 on about 83% of the fits, never more (an NVIDIA H100 run;
//      the counts are printed there, from the debug build below);
//   3. u1 = cov v1 / |cov v1|; u2 = cov v2 less its u1 part, normalized;
//      R = u1 v1^T + u2 v2^T + (u1 x u2)(v1 x v2)^T. With U' = [u1, u2,
//      u1 x u2] and V' = [v1, v2, v1 x v2] (both proper), U' V'^T equals
//      U diag(1, 1, det(U V^T)) V^T: the cross products are the reflection
//      fix, and the smallest singular value is never used.
// The error of f32 rounding in R scales as s1 over the smallest of s1 + s2,
// s1 + d s3 and s2 + d s3 (d = det(U V^T)); where that sum is small the fit
// is ill-posed and LAPACK, cuSOLVER and this kernel may each return another
// rotation. Here:
//   - cov == 0: the identity;
//   - rank 1 (|cov v2 less its u1 part| <= 1e-12 |cov v1|): u2 is u1 x e_k
//     normalized, e_k the axis of u1's smallest |component| (the first on
//     ties), with v2 as the Jacobi sweeps leave it;
//   - a NaN entry: NaN in every entry of R.
// Precision: the sweeps stay in f64. A = cov^T cov squares the fit's
// conditioning, so f32 sweeps would put about 6e-8 s1^2 / (s_i^2 - s_j^2)
// into V, past ROTFIT_TOL (1e-5) on fits that the f64 sweeps hold; the
// H100 runs f64 at half the f32 rate, and a fit is one dependent chain
// whose latency, not its issue rate, sets the time.
//
// The fused entry, riggs_estimate_rotations: estimate_rotations(source,
// target, conn) in one launch. One warp per node: the lanes stride over its
// K <= 64 edges, each reading rows i and nn_idx[i, k] of both point sets
// and adding w (t_i - t_j)(s_i - s_j)^T (the f32 differences edge_matrix
// forms, their products summed in f64; an edge whose valid is false adds
// exactly 0, as edge_matrix's where makes it); a __shfl_xor_sync butterfly
// sums the 9 accumulators over the warp; every lane runs the same fit on
// the sum (no divergence), and lanes 0-8 write R's nine entries, one
// coalesced 36-byte store. ROTFIT_WARPS = 4 warps a block: 531 nodes fill
// 133 blocks, about one an SM.
//
// Bound: bytes. The fused function reads N (24 + 9K) bytes (the node's two
// rows, K indices, weights and flags; the neighbours' rows are gathers of
// the same 24 B, counted once with their own node) and writes 36 N: at
// N = 531 and K = 10 about 80 KB, 2.4e-5 ms at 3.35 TB/s; the covariance
// entry moves 72 B a fit. No launch comes near that: one launch's fixed
// cost (a few microseconds) sets the time of a few hundred fits, so the
// design is one launch a call with nothing else around it (the stock
// gathers, where and einsum that built the covariance were 12-15 launches),
// enough blocks to keep each one's chain on its own SM, and a chain
// shortened by the early stop and the division-free rotations.
//
// Debug build: compiled with -DROTFIT_COUNT_SWEEPS, both kernels also write
// each fit's Jacobi sweeps into the int32 buffer that riggs_rotfit_sweeps_to
// names (chip_smoke.py builds and loads it on its own to count them). The
// library the wrappers load has neither the buffer nor the store.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#define ROTFIT_SWEEPS 8
#define ROTFIT_OFF 1e-12
#define ROTFIT_WARPS 4
#define ROTFIT_COV_THREADS 32
#define ROTFIT_MAX_K 64

namespace {

#ifdef ROTFIT_COUNT_SWEEPS
__device__ int* rotfit_sweeps;  // one entry a fit: node or matrix index
#endif

// One Jacobi rotation zeroing a[p][q] of the symmetric a, accumulated into v.
template <int P, int Q>
__device__ __forceinline__ void jacobi_rotate(double (&a)[3][3], double (&v)[3][3]) {
  constexpr int R = 3 - P - Q;
  const double apq = a[P][Q];
  if (fabs(apq) < 1e-150) return;  // 0, or so small that 4 apq^2 would underflow
  const double diff = a[Q][Q] - a[P][P];
  const double d = fabs(diff);
  const double q = diff * diff + 4.0 * apq * apq;
  const double h = q * rsqrt(q);
  const double w = __drcp_rn(d + h);
  const double t = (diff >= 0.0 ? 2.0 : -2.0) * apq * w;
  const double c = rsqrt(2.0 * h * w);
  const double s = t * c;
  a[P][P] -= t * apq;
  a[Q][Q] += t * apq;
  a[P][Q] = a[Q][P] = 0.0;
  const double arp = a[R][P], arq = a[R][Q];
  a[R][P] = a[P][R] = c * arp - s * arq;
  a[R][Q] = a[Q][R] = s * arp + c * arq;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double vp = v[i][P], vq = v[i][Q];
    v[i][P] = c * vp - s * vq;
    v[i][Q] = s * vp + c * vq;
  }
}

__device__ __forceinline__ void swap_cols(double& da, double& db, double (&a)[3], double (&b)[3]) {
  const double d = da;
  da = db;
  db = d;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double x = a[i];
    a[i] = b[i];
    b[i] = x;
  }
}

__device__ __forceinline__ void cross(const double (&a)[3], const double (&b)[3], double (&out)[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// The fit of one covariance m (row-major, overwritten) into r (row-major
// f32). Returns the Jacobi sweeps it ran (0 for cov == 0 or NaN).
__device__ __forceinline__ int fit_rotation(double (&m)[9], float (&r)[9]) {
  double scale = 0.0;
  bool nan = false;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    nan |= isnan(m[k]);
    scale = fmax(scale, fabs(m[k]));
  }
  if (nan || scale == 0.0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) r[k] = nan ? NAN : (k % 4 == 0 ? 1.f : 0.f);
    return 0;
  }
  const double inv = 1.0 / scale;
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] *= inv;

  // A = m^T m and V = I
  double a[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = m[i] * m[j] + m[3 + i] * m[3 + j] + m[6 + i] * m[6 + j];
      v[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  const double tr = a[0][0] + a[1][1] + a[2][2];
  const double stop = (ROTFIT_OFF * tr) * (ROTFIT_OFF * tr);
  int sweeps = 0;
  for (; sweeps < ROTFIT_SWEEPS; ++sweeps) {
    if (a[0][1] * a[0][1] + a[0][2] * a[0][2] + a[1][2] * a[1][2] <= stop) break;
    jacobi_rotate<0, 1>(a, v);
    jacobi_rotate<0, 2>(a, v);
    jacobi_rotate<1, 2>(a, v);
  }

  // eigenpairs sorted by eigenvalue, descending
  double d0 = a[0][0], d1 = a[1][1], d2 = a[2][2];
  double v0[3] = {v[0][0], v[1][0], v[2][0]};
  double v1[3] = {v[0][1], v[1][1], v[2][1]};
  double v2[3] = {v[0][2], v[1][2], v[2][2]};
  if (d1 > d0) swap_cols(d0, d1, v0, v1);
  if (d2 > d1) swap_cols(d1, d2, v1, v2);
  if (d1 > d0) swap_cols(d0, d1, v0, v1);

  // left vectors of the two largest singular values
  double u0[3], u1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u0[i] = m[3 * i] * v0[0] + m[3 * i + 1] * v0[1] + m[3 * i + 2] * v0[2];
    u1[i] = m[3 * i] * v1[0] + m[3 * i + 1] * v1[1] + m[3 * i + 2] * v1[2];
  }
  const double n0 = sqrt(u0[0] * u0[0] + u0[1] * u0[1] + u0[2] * u0[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) u0[i] /= n0;
  const double p = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] -= p * u0[i];
  double n1 = sqrt(u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]);
  if (n1 <= 1e-12 * n0) {
    // rank 1: complete u0 with the axis of its smallest |component|
    const double ax = fabs(u0[0]), ay = fabs(u0[1]), az = fabs(u0[2]);
    const int k = (ax <= ay && ax <= az) ? 0 : (ay <= az ? 1 : 2);
    const double e[3] = {k == 0 ? 1.0 : 0.0, k == 1 ? 1.0 : 0.0, k == 2 ? 1.0 : 0.0};
    cross(u0, e, u1);
    n1 = sqrt(u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] /= n1;
  double u2[3], w2[3];
  cross(u0, u1, u2);
  cross(v0, v1, w2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r[3 * i + j] = static_cast<float>(u0[i] * v0[j] + u1[i] * v1[j] + u2[i] * w2[j]);
    }
  }
  return sweeps;
}

// The covariance entry: one thread a matrix.
__global__ void __launch_bounds__(ROTFIT_COV_THREADS) rotfit_kernel(const float* __restrict__ cov,
                                                                    float* __restrict__ rot, int n) {
  const int idx = blockIdx.x * ROTFIT_COV_THREADS + threadIdx.x;
  if (idx >= n) return;
  const float* in = cov + 9 * static_cast<size_t>(idx);
  double m[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = in[k];
  float r[9];
  const int s = fit_rotation(m, r);
  float* out = rot + 9 * static_cast<size_t>(idx);
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = r[k];
#ifdef ROTFIT_COUNT_SWEEPS
  rotfit_sweeps[idx] = s;
#else
  (void)s;
#endif
}

// The fused entry: one warp a node. Rows are strided (the row stride in
// elements; each row's own entries contiguous).
__global__ void __launch_bounds__(32 * ROTFIT_WARPS)
    estimate_kernel(const float* __restrict__ src, int64_t src_stride, const float* __restrict__ tgt,
                    int64_t tgt_stride, const int32_t* __restrict__ nn_idx, int64_t idx_stride,
                    const float* __restrict__ weight, int64_t w_stride, const uint8_t* __restrict__ valid,
                    int64_t valid_stride, int n, int K, float* __restrict__ rot) {
  const int node = blockIdx.x * ROTFIT_WARPS + static_cast<int>(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (node >= n) return;  // the whole warp: node is uniform across it
  const float* si = src + node * src_stride;
  const float* ti = tgt + node * tgt_stride;
  const float s0 = si[0], s1 = si[1], s2 = si[2];
  const float t0 = ti[0], t1 = ti[1], t2 = ti[2];
  double acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.0;
  for (int k = lane; k < K; k += 32) {
    if (!valid[node * valid_stride + k]) continue;
    const int64_t j = static_cast<int64_t>(nn_idx[node * idx_stride + k]);
    const float* sj = src + j * src_stride;
    const float* tj = tgt + j * tgt_stride;
    const float es[3] = {s0 - sj[0], s1 - sj[1], s2 - sj[2]};
    const float et[3] = {t0 - tj[0], t1 - tj[1], t2 - tj[2]};
    const double w = weight[node * w_stride + k];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const double wt = w * static_cast<double>(et[a]);
#pragma unroll
      for (int b = 0; b < 3; ++b) acc[3 * a + b] += wt * static_cast<double>(es[b]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }
  float r[9];
  const int s = fit_rotation(acc, r);
  float* out = rot + 9 * static_cast<size_t>(node);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (lane == k) out[k] = r[k];
  }
#ifdef ROTFIT_COUNT_SWEEPS
  if (lane == 0) rotfit_sweeps[node] = s;
#else
  (void)s;
#endif
}

// Nothing: the launch floor that chip_smoke.py times beside the fits.
__global__ void empty_kernel() {}

}  // namespace

// One launch of an empty kernel on `stream` (the floor of a launch made
// the way the wrappers make theirs). Returns cudaGetLastError().
extern "C" int riggs_rotfit_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

#ifdef ROTFIT_COUNT_SWEEPS
// Debug build only: the next launches write each fit's sweeps into `sweeps`
// (int32, one entry a node or matrix of the largest launch). Returns the
// CUDA error of setting it.
extern "C" int riggs_rotfit_sweeps_to(int* sweeps) {
  return static_cast<int>(cudaMemcpyToSymbol(rotfit_sweeps, &sweeps, sizeof(sweeps)));
}
#endif

// rot (n, 3, 3) f32 from cov (n, 3, 3) f32, both contiguous, on `stream`.
// Returns cudaGetLastError() after the launch (0: launched); n == 0
// launches nothing.
extern "C" int riggs_fit_rotations(const float* cov, float* rot, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + ROTFIT_COV_THREADS - 1) / ROTFIT_COV_THREADS;
  rotfit_kernel<<<blocks, ROTFIT_COV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(cov, rot, n);
  return static_cast<int>(cudaGetLastError());
}

// rot (n, 3, 3) f32, contiguous, from source and target (n, 3) f32 and the
// connectivity nn_idx (n, K) int32, weight (n, K) f32 and valid (n, K)
// bool, each with its row stride in elements and its rows contiguous.
// K <= ROTFIT_MAX_K (else cudaErrorInvalidValue, nothing launched).
// Returns cudaGetLastError() after the launch (0: launched); n == 0
// launches nothing.
extern "C" int riggs_estimate_rotations(const float* src, int64_t src_stride, const float* tgt, int64_t tgt_stride,
                                        const int32_t* nn_idx, int64_t idx_stride, const float* weight,
                                        int64_t w_stride, const uint8_t* valid, int64_t valid_stride, int n, int K,
                                        float* rot, void* stream) {
  if (K < 0 || K > ROTFIT_MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int blocks = (n + ROTFIT_WARPS - 1) / ROTFIT_WARPS;
  estimate_kernel<<<blocks, 32 * ROTFIT_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      src, src_stride, tgt, tgt_stride, nn_idx, idx_stride, weight, w_stride, valid, valid_stride, n, K, rot);
  return static_cast<int>(cudaGetLastError());
}
