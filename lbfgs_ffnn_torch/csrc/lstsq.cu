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
// lstsq_min_norm_kernel<T> (lstsq_launch): a one-sided (Hestenes) Jacobi
// SVD of A = H (m <= 32 rows, n <= 32 columns) in one block of ceil(n / 2)
// warps. The columns of A and of V (V = I at the
// start) live in shared memory column by column, so a warp reads a column
// with lane = row. An odd n gets a zero dummy column, which never rotates:
// N = 2 ceil(n / 2) columns. A sweep is the N - 1 rounds of the
// round-robin (circle) tournament: in round r warp w rotates its own pair
// of columns, all N / 2 pairs at once, and the round ends at a block
// barrier; the sweep's last barrier is __syncthreads_or of "some warp
// rotated", and a sweep that rotated nothing ends the loop (at most
// kMaxSweeps). A pair costs one warp reduction, gamma = a_p . a_q: the
// squared norms alpha, beta are carried in shared memory and updated by the
// rotation in closed form (alpha -= t gamma, beta += t gamma), and computed
// afresh by reduction in the first round of every sweep (which visits every
// column once), so rounding cannot build up over more than a sweep (as
// LAPACK's xGESVJ refreshes them). A pair is left alone where gamma == 0
// or gamma^2 <= tol^2 alpha beta, tol = sqrt(m) eps. Then A = U diag(sigma)
// and V holds the right singular vectors, sigma_j = |A_j|, and
//   y = sum over kept j of V_j (A_j . b) / sigma_j^2,
// kept meaning sigma_j > 0 and sigma_j >= eps * max(m, n) * max sigma: the
// JAX cutoff. A zero column stays zero and is never kept. sigma_j and
// A_j . b are reduced one warp per column; sigma_max, the cutoff and the
// sum over j are warp 0's, in a fixed order.
//
// Bound on the card: neither bytes (under 9 KB in f64) nor operations
// (about 10 sweeps of n (n - 1) / 2 pairs, each a few 32-long dot products)
// but latency: the chain is n - 1 rounds a sweep, each one warp reduction,
// a rotation (one division, a hypot and a square root) and a barrier.
// Every reduction is a fixed tree (shuffle down to lane 0, then a
// broadcast), so every lane of a warp takes the same rotation decision,
// and the result is bitwise repeatable (a captured GMRES equals its eager
// run).
//
// lstsq_launch(elem_bytes, H, b, y, m, n, stream, launches, sweeps): H
// row-major (m, n), b (m,), y (n,) of float (elem_bytes 4) or double (8);
// launches, when not null, is an int32 device counter the kernel adds one
// to, and sweeps, when not null, one it adds its sweeps to (the last,
// which rotates nothing, included). Returns a cudaError_t (0 on success).

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 32;
constexpr int kMaxWarps = kMaxDim / 2;
constexpr int kMaxSweeps = 60;
constexpr unsigned kFull = 0xffffffffu;

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
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return __shfl_sync(kFull, v, 0);
}

// Two and three of them interleaved: the same trees, one chain of latency.
template <typename T>
__device__ __forceinline__ void warp_sum2(T& u, T& v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    u += __shfl_down_sync(kFull, u, off);
    v += __shfl_down_sync(kFull, v, off);
  }
  u = __shfl_sync(kFull, u, 0);
  v = __shfl_sync(kFull, v, 0);
}

template <typename T>
__device__ __forceinline__ void warp_sum3(T& u, T& v, T& w) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    u += __shfl_down_sync(kFull, u, off);
    v += __shfl_down_sync(kFull, v, off);
    w += __shfl_down_sync(kFull, w, off);
  }
  u = __shfl_sync(kFull, u, 0);
  v = __shfl_sync(kFull, v, 0);
  w = __shfl_sync(kFull, w, 0);
}

// The rotation of a pair: t, the smaller root of t^2 + 2 zeta t - 1 = 0,
// zeta = (beta - alpha) / (2 gamma), as sign(d) 2 gamma / (|d| + hypot(d,
// 2 gamma)), d = beta - alpha (one division, no huge zeta squared), c =
// 1 / sqrt(1 + t^2), s = c t. In f64 c is rsqrt's, one long operation
// fewer than 1 / sqrt; f32 keeps 1 / sqrtf, since rsqrtf's 2 ulp show in
// the solution.
__device__ __forceinline__ void rotation(float alpha, float beta, float gamma, float& t, float& c,
                                         float& s) {
  const float d = beta - alpha, g2 = 2.0f * gamma;
  t = g2 / (fabsf(d) + hypotf(d, g2));
  if (signbit(d)) t = -t;
  c = 1.0f / sqrtf(1.0f + t * t);
  s = c * t;
}
__device__ __forceinline__ void rotation(double alpha, double beta, double gamma, double& t,
                                         double& c, double& s) {
  const double d = beta - alpha, g2 = 2.0 * gamma;
  t = g2 / (fabs(d) + hypot(d, g2));
  if (signbit(d)) t = -t;
  c = rsqrt(1.0 + t * t);
  s = c * t;
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    lstsq_min_norm_kernel(const T* __restrict__ H, const T* __restrict__ b, T* __restrict__ y,
                          int m, int n, int* launches, int* sweep_count) {
  __shared__ T A[kMaxDim][kMaxDim];  // A[j][i]: entry i of column j
  __shared__ T V[kMaxDim][kMaxDim];
  __shared__ T nrm[kMaxDim];  // the carried squared column norms
  __shared__ T bs[kMaxDim];
  __shared__ T sig[kMaxDim];
  __shared__ T dotb[kMaxDim];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;  // = ceil(n / 2)
  const int N = 2 * W;            // the columns, the dummy included
  if (threadIdx.x == 0 && launches != nullptr) *launches += 1;
  for (int k = threadIdx.x; k < kMaxDim * kMaxDim; k += blockDim.x) {
    const int j = k / kMaxDim, i = k % kMaxDim;
    A[j][i] = j < n && i < m ? H[i * n + j] : T(0);
    V[j][i] = (i == j && j < n) ? T(1) : T(0);
  }
  if (threadIdx.x < kMaxDim) bs[lane] = lane < m ? b[lane] : T(0);
  __syncthreads();
  const T eps = Eps<T>::value;

  // LAPACK's xGESVJ threshold: the columns end orthogonal to sqrt(rows)
  // eps, and the solution's error is about cond(H) times that (m eps cost
  // f32 a factor of ten over the SVD route at cond ~ 5e4)
  const T tol = eps * sqrt(T(m));
  const T tol2 = tol * tol;
  // warp w's pair in round r of the round-robin tournament over N columns:
  // column N - 1 stays, the others turn; u = (r + w) mod (N - 1), v = (r -
  // w) mod (N - 1) (for w = 0: u = r, v = N - 1), both one up each round,
  // so a sweep of N - 1 rounds ends where it began (ops/cuda_lstsq.py:
  // round_robin)
  const int M = N - 1;
  int u = warp, v = warp == 0 ? M : M - warp;
  int sweeps = 0;
  while (sweeps < kMaxSweeps) {
    ++sweeps;
    bool rotated = false;
    for (int r = 0; r < M; ++r) {
      const int p = min(u, v), q = max(u, v);
      u = u + 1 == M ? 0 : u + 1;
      if (warp != 0) v = v + 1 == M ? 0 : v + 1;
      const T ap = A[p][lane], aq = A[q][lane];
      T alpha, beta, gamma = ap * aq;
      if (r == 0) {  // every column once: its norm afresh
        alpha = ap * ap;
        beta = aq * aq;
        warp_sum3(alpha, beta, gamma);
      } else {
        gamma = warp_sum(gamma);
        alpha = nrm[p];
        beta = nrm[q];
      }
      // uniform across the warp: the sums are the same bits in every lane
      if (!(gamma == T(0) || gamma * gamma <= (tol2 * alpha) * beta)) {
        T t, c, s;
        rotation(alpha, beta, gamma, t, c, s);
        A[p][lane] = c * ap - s * aq;
        A[q][lane] = s * ap + c * aq;
        const T vp = V[p][lane], vq = V[q][lane];
        V[p][lane] = c * vp - s * vq;
        V[q][lane] = s * vp + c * vq;
        alpha -= t * gamma;
        beta += t * gamma;
        rotated = true;
      }
      if (lane == 0) {
        nrm[p] = alpha;
        nrm[q] = beta;
      }
      if (r < M - 1)
        __syncthreads();
      else
        rotated = __syncthreads_or(rotated);
    }
    if (!rotated) break;
  }

  // sigma_j and the dot with b, one warp per column
  for (int j = warp; j < n; j += W) {
    const T a = A[j][lane];
    T s2 = a * a, d = a * bs[lane];
    warp_sum2(s2, d);
    if (lane == 0) {
      sig[j] = sqrt(s2);
      dotb[j] = d;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const T s = lane < n ? sig[lane] : T(0);
    T smax = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) smax = fmax(smax, __shfl_xor_sync(kFull, smax, off));
    const T cutoff = eps * T(m > n ? m : n) * smax;
    const T coef = (lane < n && s > T(0) && s >= cutoff) ? (dotb[lane] / s) / s : T(0);
    T acc = T(0);
    for (int j = 0; j < n; ++j) acc += V[j][lane] * __shfl_sync(kFull, coef, j);
    if (lane < n) y[lane] = acc;
    if (lane == 0 && sweep_count != nullptr) *sweep_count += sweeps;
  }
}

}  // namespace

extern "C" int lstsq_launch(int elem_bytes, const void* H, const void* b, void* y, int m, int n,
                            void* stream, void* launches, void* sweeps) {
  if (m < 1 || n < 1 || m > kMaxDim || n > kMaxDim) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* count = static_cast<int*>(launches);
  int* swept = static_cast<int*>(sweeps);
  const int threads = 32 * ((n + 1) / 2);
  if (elem_bytes == 8) {
    lstsq_min_norm_kernel<double><<<1, threads, 0, st>>>(
        static_cast<const double*>(H), static_cast<const double*>(b), static_cast<double*>(y), m,
        n, count, swept);
  } else if (elem_bytes == 4) {
    lstsq_min_norm_kernel<float><<<1, threads, 0, st>>>(
        static_cast<const float*>(H), static_cast<const float*>(b), static_cast<float*>(y), m, n,
        count, swept);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* lstsq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
