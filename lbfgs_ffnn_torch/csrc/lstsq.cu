// Minimum-norm least squares of a small dense system on the card, for the
// GMRES cycle's update (lbfgs_ffnn_torch/ops/iterative.py: gmres_counted).
//
// Replaces jnp.linalg.lstsq(H, beta) in lbfgs_ffnn_tpu/ops/iterative.py:113
// (no Pallas kernel: XLA's SVD there). The JAX function returns the
// minimum-norm solution through an SVD, singular values below
// eps * max(M, N) * sigma_max (and exact zeros) treated as zero. GMRES's
// (restart + 1) x restart Hessenberg matrix is rank-deficient after a happy
// breakdown (zero columns), so a QR solve (torch.linalg.lstsq's only CUDA
// driver, gels) is no substitute, and torch.linalg.svd / pinv on CUDA read
// a convergence flag on the host, which a CUDA graph capture refuses.
//
// lstsq_min_norm_kernel<T>: one warp, one block. Lane r keeps row r of the
// matrix A (m <= 32 rows, n <= 32 columns) and row r of V in shared memory;
// every lane touches only its own rows, so the warp needs no barrier. The
// one-sided (Hestenes) Jacobi SVD rotates column pairs (p, q) cyclically
// until every pair is orthogonal to sqrt(m) eps of their norms (at most
// kMaxSweeps sweeps); then A = U diag(sigma) and V holds the right singular
// vectors, sigma_j = |A_j|. The solution is
//   y = sum over kept j of V_j (A_j . b) / sigma_j^2,
// kept meaning sigma_j > 0 and sigma_j >= eps * max(m, n) * max sigma: the
// JAX cutoff. A zero column stays zero and is never kept.
//
// Bound on the card: neither bytes (under 4 KB in f64) nor operations
// (about 10 sweeps of 190 pairs at n = 20, each a few 21-long dot products)
// but latency: every pair is three warp reductions in a row. One warp is
// what a 21-row problem fills; the design keeps every reduction a fixed
// tree (shuffle down to lane 0, then a broadcast) so all lanes take the
// same rotation decisions and the result is bitwise repeatable (a captured
// GMRES equals its eager run).
//
// lstsq_launch(elem_bytes, H, b, y, m, n, stream, launches): H row-major
// (m, n), b (m,), y (n,) of float (elem_bytes 4) or double (8); launches,
// when not null, is an int32 device counter the kernel adds one to. Returns
// a cudaError_t (0 on success).

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 32;
constexpr int kMaxSweeps = 60;

template <typename T>
struct Eps;
template <>
struct Eps<float> {
  static constexpr float value = FLT_EPSILON;
};
template <>
struct Eps<double> {
  static constexpr double value = DBL_EPSILON;
};

// The warp's sum in a fixed order, the same bits in every lane.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

template <typename T>
__global__ void __launch_bounds__(32, 1)
    lstsq_min_norm_kernel(const T* __restrict__ H, const T* __restrict__ b, T* __restrict__ y,
                          int m, int n, int* launches) {
  __shared__ T A[kMaxDim][kMaxDim + 1];
  __shared__ T V[kMaxDim][kMaxDim + 1];
  const int lane = threadIdx.x;
  if (lane == 0 && launches != nullptr) *launches += 1;
  for (int j = 0; j < n; ++j) {
    A[lane][j] = lane < m ? H[lane * n + j] : T(0);
    V[lane][j] = lane == j ? T(1) : T(0);  // lanes >= n hold zero rows of V
  }
  const T bl = lane < m ? b[lane] : T(0);
  const T eps = Eps<T>::value;
  // LAPACK's xGESVJ threshold: the columns end orthogonal to sqrt(m) eps,
  // and the solution's error is about cond(H) times that (m eps cost f32
  // a factor of ten over the SVD route at cond ~ 5e4)
  const T tol = eps * sqrt(T(m));

  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const T ap = A[lane][p], aq = A[lane][q];
        const T alpha = warp_sum(ap * ap);
        const T beta = warp_sum(aq * aq);
        const T gamma = warp_sum(ap * aq);
        // uniform across the warp: the sums are the same bits in every lane
        if (gamma == T(0) || fabs(gamma) <= tol * sqrt(alpha) * sqrt(beta)) continue;
        const T zeta = (beta - alpha) / (T(2) * gamma);
        const T az = fabs(zeta);
        // the smaller root of t^2 + 2 zeta t - 1 = 0 (|t| <= 1), without
        // squaring a huge zeta
        T t = az > T(1) / eps ? T(0.5) / az : T(1) / (az + sqrt(T(1) + az * az));
        t = copysign(t, zeta);
        const T c = T(1) / sqrt(T(1) + t * t);
        const T s = c * t;
        A[lane][p] = c * ap - s * aq;
        A[lane][q] = s * ap + c * aq;
        const T vp = V[lane][p], vq = V[lane][q];
        V[lane][p] = c * vp - s * vq;
        V[lane][q] = s * vp + c * vq;
        rotated = true;
      }
    }
    if (!rotated) break;
  }

  T smax = T(0);
  for (int j = 0; j < n; ++j) {
    const T a = A[lane][j];
    smax = fmax(smax, sqrt(warp_sum(a * a)));
  }
  const T cutoff = eps * T(m > n ? m : n) * smax;
  T acc = T(0);
  for (int j = 0; j < n; ++j) {
    const T a = A[lane][j];
    const T sigma = sqrt(warp_sum(a * a));
    const T ab = warp_sum(a * bl);
    const T coef = (sigma > T(0) && sigma >= cutoff) ? (ab / sigma) / sigma : T(0);
    acc += V[lane][j] * coef;
  }
  if (lane < n) y[lane] = acc;
}

}  // namespace

extern "C" int lstsq_launch(int elem_bytes, const void* H, const void* b, void* y, int m, int n,
                            void* stream, void* launches) {
  if (m < 1 || n < 1 || m > kMaxDim || n > kMaxDim) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* count = static_cast<int*>(launches);
  if (elem_bytes == 8) {
    lstsq_min_norm_kernel<double><<<1, 32, 0, st>>>(static_cast<const double*>(H),
                                                    static_cast<const double*>(b),
                                                    static_cast<double*>(y), m, n, count);
  } else if (elem_bytes == 4) {
    lstsq_min_norm_kernel<float><<<1, 32, 0, st>>>(static_cast<const float*>(H),
                                                   static_cast<const float*>(b),
                                                   static_cast<float*>(y), m, n, count);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* lstsq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
