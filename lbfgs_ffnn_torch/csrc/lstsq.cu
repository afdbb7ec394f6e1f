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
// lstsq_min_norm_kernel<T> (lstsq_launch): a Givens triangle, then a
// one-sided (Hestenes) Jacobi SVD on its rows, of H (m <= 32 rows, n <= 32
// columns) in one block of ceil(K / 2) warps, K = min(m, n). Row i of H,
// with b_i carried after it, lives in shared memory as R[i][0..n-1],
// R[i][n] (lane = column), so a rotation of two rows also rotates their b
// entries and no V is formed. Lane n holds b's entry and is left out of the
// dot products; at n = 32 it lies past the lanes, in R[i][32], and every
// lane rotates it alike (lane 0 stores it).
//
// Why rows, and why the triangle first: one-sided Jacobi on a matrix's
// columns is accurate whatever the columns' scaling (Demmel-Veselic), but
// not whatever its rows' scaling, and a GMRES cycle whose subdiagonal
// shrinks leaves H graded by rows (1e-5 over 21 rows: the sweeps on H's
// columns read 7e-9 of the solution's largest entry where JAX's SVD reads
// 1e-15). On the rows of R = Q^T H, which carry that grading, the sweeps
// are accurate (Drmac's preconditioned Jacobi: 2e-12 there); on H's own
// rows too, but the row below the triangle never settles and they take 12
// to 19 sweeps, against 7 to 9 on R's.
//
// The triangle (warp 0): for column j < min(n, m - 1), row j + 1 and then
// each row i > j + 1 whose entry (i, j) is not zero (a ballot finds them)
// is rotated against row j (r = hypot(a, c), cos = a (1 / r), sin = c (1 /
// r)), entry (i, j) stored as exactly 0 and (j, j) as r. Row j, the pivot,
// stays in registers from its first rotation to its last, and row j + 1
// becomes the next pivot there. On GMRES's (n + 1) x n upper Hessenberg H
// that is one rotation a column, rows j and j + 1, a chain of n through
// registers and shuffles alone; it leaves rows 0..n-1 upper triangular and
// row n zero in H's columns (its b entry is the residual). On any other H
// it is a Givens QR, rows K.. zero: the sweeps need only rows 0..K-1
// (Jacobi on the rows of any orthogonal transform of H gives the same
// minimum-norm y). A zero column of H stays exactly zero under row
// rotations, and a zero entry (a happy breakdown) is skipped.
//
// The sweeps: an odd K gets a dummy row K, zero in H's columns, which never
// rotates: N = 2 ceil(K / 2) rows. A sweep is the N - 1 rounds of the
// round-robin (circle) tournament: in round r warp w rotates its own pair
// of rows, all N / 2 pairs at once, and the round ends at a block
// barrier; the sweep's last barrier is __syncthreads_or of "some warp
// rotated", and a sweep that rotated nothing ends the loop (at most
// kMaxSweeps). A pair costs one warp reduction over H's columns, gamma =
// r_p . r_q: the squared norms alpha, beta are carried in shared memory and
// updated by the rotation in closed form (alpha -= t gamma, beta += t
// gamma), and computed afresh by reduction in the first round of every
// sweep (which visits every row once), so rounding cannot build up over
// more than a sweep (as LAPACK's xGESVJ refreshes them). A pair is left
// alone where gamma == 0 or gamma^2 <= tol^2 alpha beta, tol = sqrt(n) eps.
// Then the rows r_i = sigma_i v_i^T, sigma_i = |r_i|, and
//   y = sum over kept i of r_i c_i / sigma_i^2,
// c_i row i's carried b entry, kept meaning sigma_i > 0 and sigma_i >= eps *
// max(m, n) * max sigma: the JAX cutoff. sigma_i is reduced one warp per
// row; sigma_max, the cutoff and the sum over i are warp 0's, in a fixed
// order.
//
// Bound on the card: neither bytes (under 9 KB in f64) nor operations
// (about 10 sweeps of K (K - 1) / 2 pairs, each a few 32-long dot products,
// and a triangle of n rotations) but latency: the triangle is a chain of n
// dependent rotations (a hypot and a division each), and the sweeps N - 1
// rounds each, a round one warp reduction, a rotation (one division and
// two square roots) and a barrier. Every reduction is a fixed tree
// (shuffle down to lane 0, then a broadcast), so every lane of a warp takes
// the same rotation decision, and the result is bitwise repeatable (a
// captured GMRES equals its eager run). No operation is contracted or
// approximate (no rsqrt, no library hypot), so the numpy mirror makes the
// same sweeps on every matrix, graded ones included.
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
constexpr int kRow = kMaxDim + 1;  // a row of R: H's n columns, b's entry, zeros
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

// Three of them interleaved: the same trees, one chain of latency.
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

// Every product, sum and difference below is rounded on its own (the _rn
// intrinsics, which nvcc never contracts into a fused multiply-add), and
// every square root and division is IEEE's, so the numpy mirror
// (ops/cuda_lstsq.py: jacobi_mirror) gets the same bits and the same sweeps.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// The powers of two S and 1 / S that bring big (>= 0) to [1, 2): exponent
// bits alone, clamped so both stay normal (a subnormal, an infinity or a
// NaN gets the end of the range), so a multiply by either is exact.
__device__ __forceinline__ void pow2(float big, float& S, float& Sinv) {
  const int e = min(max((__float_as_int(big) >> 23) & 0xff, 1), 253);
  S = __int_as_float((254 - e) << 23);
  Sinv = __int_as_float(e << 23);
}
__device__ __forceinline__ void pow2(double big, double& S, double& Sinv) {
  const int e = min(max((__double2hiint(big) >> 20) & 0x7ff, 1), 2045);
  S = __hiloint2double((2046 - e) << 20, 0);
  Sinv = __hiloint2double(e << 20, 0);
}

// hypot(x, y) as sqrt(xs^2 + ys^2) / S, xs = x S, ys = y S: no overflow, no
// harmful underflow, and IEEE operations alone.
template <typename T>
__device__ __forceinline__ T hyp(T x, T y) {
  T S, Sinv;
  pow2(fmax(fabs(x), fabs(y)), S, Sinv);
  const T xs = mul(x, S), ys = mul(y, S);
  return mul(sqrt(add(mul(xs, xs), mul(ys, ys))), Sinv);
}

// The rotation of a pair: t, the smaller root of t^2 + 2 zeta t - 1 = 0,
// zeta = (beta - alpha) / (2 gamma), is g / u, with d = beta - alpha and
// g = sign(d) 2 gamma scaled by S (which leaves t as it is: no overflow, no
// huge zeta squared), h = sqrt(d^2 + g^2) and u = |d| + h; c = 1 / sqrt(1
// + t^2) = u / w and s = c t = g / w, w = sqrt(u^2 + g^2). One division
// serves the three: q = 1 / (u w), t = g w q, c = u u q, s = g u q.
template <typename T>
__device__ __forceinline__ void rotation(T alpha, T beta, T gamma, T& t, T& c, T& s) {
  const T d = sub(beta, alpha), g2 = mul(T(2), gamma);
  T S, Sinv;
  pow2(fmax(fabs(d), fabs(g2)), S, Sinv);
  const T ds = mul(d, S), g = signbit(d) ? -mul(g2, S) : mul(g2, S);
  const T h = sqrt(add(mul(ds, ds), mul(g, g)));
  const T u = add(fabs(ds), h);
  const T w = sqrt(add(mul(u, u), mul(g, g)));
  const T q = T(1) / mul(u, w);
  t = mul(mul(g, w), q);
  c = mul(mul(u, u), q);
  s = mul(mul(g, u), q);
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    lstsq_min_norm_kernel(const T* __restrict__ H, const T* __restrict__ b, T* __restrict__ y,
                          int m, int n, int* launches, int* sweep_count) {
  __shared__ T R[kMaxDim][kRow];  // R[i][k]: entry k of row i; R[i][n]: its b entry
  __shared__ T nrm[kMaxDim];      // the carried squared row norms
  __shared__ T sig[kMaxDim];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;  // = ceil(K / 2)
  const int N = 2 * W;            // the rows swept, the dummy included
  const int K = min(m, n);
  const bool wide = n == kMaxDim;  // b's entry past the lanes: every lane rotates it alike
  if (threadIdx.x == 0 && launches != nullptr) *launches += 1;
  for (int k = threadIdx.x; k < kMaxDim * kRow; k += blockDim.x) {
    const int i = k / kRow, j = k % kRow;
    R[i][j] = i >= m ? T(0) : j < n ? H[i * n + j] : j == n ? b[i] : T(0);
  }
  __syncthreads();
  const T eps = Eps<T>::value;

  if (warp == 0) {  // the Givens triangle; the pivot row j in registers
    const int J = min(n, m - 1);
    T cur = R[0][lane], bcur = wide ? R[0][kMaxDim] : T(0);
    for (int j = 0; j < J; ++j) {
      T nxt = R[j + 1][lane], bnxt = wide ? R[j + 1][kMaxDim] : T(0);
      // the rows below j + 1 whose entry (i, j) is not zero (none on a
      // Hessenberg H), rotated into row j after row j + 1; a NaN rotates
      const T x = lane > j + 1 && lane < m ? R[lane][j] : T(0);
      unsigned rows = __ballot_sync(kFull, x != T(0));
      T a = __shfl_sync(kFull, cur, j);
      const T c1 = __shfl_sync(kFull, nxt, j);
      if (c1 != T(0)) {
        const T r = hyp(a, c1);
        const T inv = T(1) / r;
        const T cs = mul(a, inv), sn = mul(c1, inv);
        const T pj = cur;
        cur = lane == j ? r : add(mul(cs, pj), mul(sn, nxt));
        nxt = lane == j ? T(0) : sub(mul(cs, nxt), mul(sn, pj));
        const T bj = bcur;
        bcur = add(mul(cs, bj), mul(sn, bnxt));
        bnxt = sub(mul(cs, bnxt), mul(sn, bj));
        a = r;
      }
      const bool more = rows != 0u;
      while (rows != 0u) {
        const int i = __ffs(rows) - 1;
        rows &= rows - 1u;
        const T c = __shfl_sync(kFull, x, i);
        const T r = hyp(a, c);
        const T inv = T(1) / r;
        const T cs = mul(a, inv), sn = mul(c, inv);
        const T pj = cur, pi = R[i][lane];
        cur = lane == j ? r : add(mul(cs, pj), mul(sn, pi));
        R[i][lane] = lane == j ? T(0) : sub(mul(cs, pi), mul(sn, pj));
        if (wide) {
          const T bi = R[i][kMaxDim];
          const T bj = bcur;
          bcur = add(mul(cs, bj), mul(sn, bi));
          __syncwarp();  // every lane has read b_i
          if (lane == 0) R[i][kMaxDim] = sub(mul(cs, bi), mul(sn, bj));
        }
        a = r;
      }
      R[j][lane] = cur;  // row j is done
      if (wide && lane == 0) R[j][kMaxDim] = bcur;
      cur = nxt;
      bcur = bnxt;
      if (more) __syncwarp();  // the rotated rows below are read across lanes
    }
    R[J][lane] = cur;
    if (wide && lane == 0) R[J][kMaxDim] = bcur;
  }
  __syncthreads();

  // LAPACK's xGESVJ threshold: the rows end orthogonal to sqrt(row length)
  // eps, and the solution's error is about cond(H) times that
  const T tol = eps * sqrt(T(n));
  const T tol2 = tol * tol;
  // warp w's pair in round r of the round-robin tournament over N rows:
  // row N - 1 stays, the others turn; u = (r + w) mod (N - 1), v = (r - w)
  // mod (N - 1) (for w = 0: u = r, v = N - 1), both one up each round, so a
  // sweep of N - 1 rounds ends where it began (ops/cuda_lstsq.py:
  // round_robin)
  const int M = N - 1;
  const bool in_h = lane < n;  // lane n holds b's entry, left out of the sums
  int u = warp, v = warp == 0 ? M : M - warp;
  int sweeps = 0;
  while (sweeps < kMaxSweeps) {
    ++sweeps;
    bool rotated = false;
    for (int r = 0; r < M; ++r) {
      const int p = min(u, v), q = max(u, v);
      u = u + 1 == M ? 0 : u + 1;
      if (warp != 0) v = v + 1 == M ? 0 : v + 1;
      const T ap = R[p][lane], aq = R[q][lane];
      const T hp = in_h ? ap : T(0), hq = in_h ? aq : T(0);
      T alpha, beta, gamma = mul(hp, hq);
      if (r == 0) {  // every row once: its norm afresh
        alpha = mul(hp, hp);
        beta = mul(hq, hq);
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
        R[p][lane] = sub(mul(c, ap), mul(s, aq));
        R[q][lane] = add(mul(s, ap), mul(c, aq));
        if (wide) {
          const T bp = R[p][kMaxDim], bq = R[q][kMaxDim];
          __syncwarp();  // every lane has read them
          if (lane == 0) {
            R[p][kMaxDim] = sub(mul(c, bp), mul(s, bq));
            R[q][kMaxDim] = add(mul(s, bp), mul(c, bq));
          }
        }
        alpha = sub(alpha, mul(t, gamma));
        beta = add(beta, mul(t, gamma));
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

  // sigma_i, one warp per row
  for (int i = warp; i < K; i += W) {
    const T a = in_h ? R[i][lane] : T(0);
    const T s2 = warp_sum(mul(a, a));
    if (lane == 0) sig[i] = sqrt(s2);
  }
  __syncthreads();
  if (warp == 0) {
    const T s = lane < K ? sig[lane] : T(0);
    T smax = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) smax = fmax(smax, __shfl_xor_sync(kFull, smax, off));
    const T cutoff = eps * T(m > n ? m : n) * smax;
    const T coef = (lane < K && s > T(0) && s >= cutoff) ? (R[lane][n] / s) / s : T(0);
    T acc = T(0);
    for (int i = 0; i < K; ++i) acc = add(acc, mul(R[i][lane], __shfl_sync(kFull, coef, i)));
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
  const int K = m < n ? m : n;
  const int threads = 32 * ((K + 1) / 2);
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
