// Batched best-fit rotations from 3x3 correlation matrices, for Hopper
// (sm_90a): the kernel behind riggs_tpu_torch/ops/geometry.py:fit_rotations.
//
// Replaces no Pallas kernel: riggs_tpu/ops/geometry.py:fit_rotations is a
// stock jnp.linalg.svd that XLA lowers. Its torch counterpart,
// torch.linalg.svd on the card, checks its convergence flags on the host
// (two blocking reads a call, one call a stage-1 step in the ARAP loss).
// This kernel reads nothing back.
//
// For each f32 matrix cov = U S V^T it writes R = U diag(1, 1, det(U V^T))
// V^T, the proper rotation that maximizes trace(R^T cov). One thread per
// matrix, everything in f64 registers:
//   1. cov is scaled by its largest |entry| (the identity if that is 0);
//      A = cov^T cov;
//   2. ROTFIT_SWEEPS cyclic Jacobi sweeps over (0,1), (0,2), (1,2)
//      diagonalize A: its eigenvectors V and eigenvalues S^2, sorted
//      descending (a sorting network, stable on ties);
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
//
// Bound: the function moves 36 B in and 36 B out a matrix, so HBM bounds
// it; the f64 Jacobi sweeps are this design's extra work, not the
// function's. The batches are a few hundred matrices a stage-1 step, so one
// launch's fixed cost sets the time; the design keeps it to one launch and
// no host read.
#include <cuda_runtime.h>

#include <cmath>

#define ROTFIT_SWEEPS 8
#define ROTFIT_THREADS 128

namespace {

// One Jacobi rotation zeroing a[p][q] of the symmetric a, accumulated into v.
template <int P, int Q>
__device__ __forceinline__ void jacobi_rotate(double (&a)[3][3], double (&v)[3][3]) {
  constexpr int R = 3 - P - Q;
  const double apq = a[P][Q];
  if (apq == 0.0) return;
  const double theta = (a[Q][Q] - a[P][P]) / (2.0 * apq);
  const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
  const double c = 1.0 / sqrt(t * t + 1.0);
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

__global__ void __launch_bounds__(ROTFIT_THREADS) rotfit_kernel(const float* __restrict__ cov,
                                                                float* __restrict__ rot, int n) {
  const int idx = blockIdx.x * ROTFIT_THREADS + threadIdx.x;
  if (idx >= n) return;
  const float* in = cov + 9 * static_cast<size_t>(idx);
  float* out = rot + 9 * static_cast<size_t>(idx);

  double m[3][3];
  double scale = 0.0;
  bool nan = false;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const double x = in[k];
    m[k / 3][k % 3] = x;
    nan |= isnan(x);
    scale = fmax(scale, fabs(x));
  }
  if (nan || scale == 0.0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = nan ? NAN : (k % 4 == 0 ? 1.f : 0.f);
    return;
  }
  const double inv = 1.0 / scale;
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k / 3][k % 3] *= inv;

  // A = m^T m and V = I
  double a[3][3], v[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[r][c] = m[0][r] * m[0][c] + m[1][r] * m[1][c] + m[2][r] * m[2][c];
      v[r][c] = r == c ? 1.0 : 0.0;
    }
  }
#pragma unroll
  for (int sweep = 0; sweep < ROTFIT_SWEEPS; ++sweep) {
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
    u0[i] = m[i][0] * v0[0] + m[i][1] * v0[1] + m[i][2] * v0[2];
    u1[i] = m[i][0] * v1[0] + m[i][1] * v1[1] + m[i][2] * v1[2];
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
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[3 * r + c] = static_cast<float>(u0[r] * v0[c] + u1[r] * v1[c] + u2[r] * w2[c]);
    }
  }
}

}  // namespace

// rot (n, 3, 3) f32 from cov (n, 3, 3) f32, both contiguous, on `stream`.
// Returns cudaGetLastError() after the launch (0: launched); n == 0
// launches nothing.
extern "C" int riggs_fit_rotations(const float* cov, float* rot, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + ROTFIT_THREADS - 1) / ROTFIT_THREADS;
  rotfit_kernel<<<blocks, ROTFIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(cov, rot, n);
  return static_cast<int>(cudaGetLastError());
}
