// L-BFGS two-loop recursion r = H v in one persistent cooperative kernel.
//
// Replaces the TPU kernel lbfgs_ffnn_tpu/ops/pallas_two_loop.py::
// _kernel_resident (reached through _two_loop_pallas_padded), which pulls
// the whole (S, Y) history into VMEM with two bulk DMAs and runs both passes
// from there on one core. The same function, computed for Hopper:
//
//   backward, newest -> oldest:  a_i = rho_i s_i.q ;  q -= a_i y_i
//   gamma = s.y / y.y of the newest pair (1 if count == 0 or y.y <= 0;
//           with clamp_gamma: 1 if |y.y| < 1e-12, then clipped)
//   z = gamma q
//   forward, oldest -> newest:   b = rho_i y_i.z ;  z += (a_i - b) s_i
//
// Design. One block's shared memory (227 KB) cannot hold the headline's
// working vector (101,888 floats padded, 407 KB), so the vector is split:
// each block owns one contiguous slice of q (later z) in shared memory for
// the whole call, and the 2*count sequential stages run inside one launch.
// A stage is: partial dot over the block's slice -> block reduction ->
// partials[block] -> grid.sync() -> every block sums all partials in the
// same fixed order (so every block, and every run, gets the bitwise same
// scalar; no atomics) -> local axpy on the slice. The newest pair's s.y and
// y.y ride along in the first stage. That is 2*count grid barriers and one
// launch per direction, where a per-op port issues about 4m kernels.
//
// Bound on this card: each call reads 4*count*n*4 bytes of history (16 MB at
// m = 10, n = 101,770). The whole 8 MB ring of the headline fits in the
// 50 MB L2 and stays there between iterations, so the stages are bound by
// L2 latency and bandwidth and by the grid barrier, not by HBM; q never
// leaves the SMs. Staging rows with cp.async/TMA and merging one stage's
// axpy with the next stage's dot are left for later.
//
// The grid is sized so that every block is resident at once (a condition
// of grid.sync()): occupancy x SMs, capped by the number of 1024-float
// slices. head, count and rho are read on the device; the host never
// reads them. Launches on the caller's stream; allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSliceUnit = kThreads * 4;  // one float4 per thread
constexpr int kMaxM = 1024;               // alphas live in shared memory
constexpr int kNumPartials = 3;           // values reduced per stage (at most)

struct Params {
  const float* v;      // (n_pad,)
  const float* S;      // (m, n_pad)
  const float* Y;      // (m, n_pad)
  const float* rho;    // (m,)
  const int* head;     // scalar
  const int* count;    // scalar
  float* out;          // (n_pad,)
  float* partials;     // (2, kNumPartials, gridDim.x) scratch
  int n_pad;
  int m;
  int slice;           // floats per block, a multiple of 4
  int clamp_gamma;
  float gamma_min;
  float gamma_max;
};

// Sum NV values over the block; the totals are valid in thread 0.
template <int NV>
__device__ void block_sum(float (&vals)[NV], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    float x = vals[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[c * kWarps + warp] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[c * kWarps + w];
      vals[c] = s;
    }
  }
  __syncthreads();  // red is free again
}

// Sum NV per-block partials over the whole grid. Every block adds the
// partials in the same order, so all blocks return bitwise-equal totals.
// `buf` alternates between stages: a block may write the next stage's
// partial before a slower block has read this stage's.
template <int NV>
__device__ void grid_sum(float (&vals)[NV], const Params& p, int buf,
                         cg::grid_group& grid, float* red, float* bcast) {
  const int nblk = gridDim.x;
  float* part = p.partials + (size_t)buf * kNumPartials * nblk;
  block_sum<NV>(vals, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) __stcg(part + c * nblk + blockIdx.x, vals[c]);
  }
  grid.sync();
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    float acc = 0.f;
    for (int t = threadIdx.x; t < nblk; t += kThreads) acc += __ldcg(part + c * nblk + t);
    vals[c] = acc;
  }
  block_sum<NV>(vals, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) bcast[c] = vals[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NV; ++c) vals[c] = bcast[c];
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__global__ void __launch_bounds__(kThreads) two_loop_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 q4[];  // this block's slice of q, then z
  __shared__ float alphas[kMaxM];
  __shared__ float red[kNumPartials * kWarps];
  __shared__ float bcast[kNumPartials];

  const int start = blockIdx.x * p.slice;
  const int len4 = max(0, min(p.slice, p.n_pad - start)) / 4;
  const int m = p.m;
  const int head = *p.head;
  const int count = min(*p.count, m);  // <= m by the ring's invariant
  const float4* v4 = reinterpret_cast<const float4*>(p.v + start);
  float4* out4 = reinterpret_cast<float4*>(p.out + start);

  // Each thread touches only the float4s k = tid, tid + kThreads, ... of
  // the slice in every loop below, so q4 needs no block barrier of its own.
  for (int k = threadIdx.x; k < len4; k += kThreads) q4[k] = v4[k];

  int buf = 0;
  float gamma = 1.f;
  for (int j = 0; j < count; ++j) {  // backward: newest -> oldest
    const int i = ((head - 1 - j) % m + m) % m;
    const float4* s4 = reinterpret_cast<const float4*>(p.S + (size_t)i * p.n_pad + start);
    const float4* y4 = reinterpret_cast<const float4*>(p.Y + (size_t)i * p.n_pad + start);
    float a;
    if (j == 0) {
      float vals[3] = {0.f, 0.f, 0.f};  // s.q, s.y, y.y
      for (int k = threadIdx.x; k < len4; k += kThreads) {
        const float4 s = s4[k], y = y4[k];
        vals[0] += dot4(s, q4[k]);
        vals[1] += dot4(s, y);
        vals[2] += dot4(y, y);
      }
      grid_sum<3>(vals, p, buf, grid, red, bcast);
      a = p.rho[i] * vals[0];
      const float ys = vals[1], yy = vals[2];
      if (p.clamp_gamma) {
        gamma = fabsf(yy) < 1e-12f ? 1.f : ys / (yy == 0.f ? 1.f : yy);
        gamma = gamma < p.gamma_min ? p.gamma_min : gamma;  // NaN passes through
        gamma = gamma > p.gamma_max ? p.gamma_max : gamma;
      } else {
        gamma = yy > 0.f ? ys / yy : 1.f;
      }
    } else {
      float vals[1] = {0.f};
      for (int k = threadIdx.x; k < len4; k += kThreads) vals[0] += dot4(s4[k], q4[k]);
      grid_sum<1>(vals, p, buf, grid, red, bcast);
      a = p.rho[i] * vals[0];
    }
    buf ^= 1;
    if (threadIdx.x == 0) alphas[count - 1 - j] = a;
    for (int k = threadIdx.x; k < len4; k += kThreads) {
      const float4 y = y4[k];
      float4 q = q4[k];
      q.x -= a * y.x; q.y -= a * y.y; q.z -= a * y.z; q.w -= a * y.w;
      q4[k] = q;
    }
  }

  for (int k = threadIdx.x; k < len4; k += kThreads) {
    float4 q = q4[k];
    q.x *= gamma; q.y *= gamma; q.z *= gamma; q.w *= gamma;
    q4[k] = q;
  }
  __syncthreads();  // alphas written by thread 0 above

  for (int li = 0; li < count; ++li) {  // forward: oldest -> newest
    const int i = ((head - count + li) % m + m) % m;
    const float4* s4 = reinterpret_cast<const float4*>(p.S + (size_t)i * p.n_pad + start);
    const float4* y4 = reinterpret_cast<const float4*>(p.Y + (size_t)i * p.n_pad + start);
    float vals[1] = {0.f};
    for (int k = threadIdx.x; k < len4; k += kThreads) vals[0] += dot4(y4[k], q4[k]);
    grid_sum<1>(vals, p, buf, grid, red, bcast);
    buf ^= 1;
    const float coef = alphas[li] - p.rho[i] * vals[0];
    for (int k = threadIdx.x; k < len4; k += kThreads) {
      const float4 s = s4[k];
      float4 z = q4[k];
      z.x += coef * s.x; z.y += coef * s.y; z.z += coef * s.z; z.w += coef * s.w;
      q4[k] = z;
    }
  }

  for (int k = threadIdx.x; k < len4; k += kThreads) out4[k] = q4[k];
}

static int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Launch geometry for (n_pad, m) on the current device: the grid, the
// floats per block and the dynamic shared memory. Returns a cudaError_t.
extern "C" int two_loop_config(int n_pad, int m, int* grid_out, int* slice_out) {
  if (n_pad <= 0 || n_pad % 4 != 0 || m <= 0 || m > kMaxM) return cudaErrorInvalidValue;
  int dev, sms, coop;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  // Allow every launch all the shared memory a block may opt into.
  int optin;
  cudaFuncAttributes fa;
  if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess) return e;
  if ((e = cudaFuncGetAttributes(&fa, two_loop_kernel)) != cudaSuccess) return e;
  const int max_dyn = optin - (int)fa.sharedSizeBytes;
  if ((e = cudaFuncSetAttribute(two_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                max_dyn)) != cudaSuccess) return e;
  // Occupancy at the largest slice any grid of >= one block per SM uses.
  const int slice1 = ceil_div(ceil_div(n_pad, sms), 4) * 4;
  if (slice1 * (int)sizeof(float) > max_dyn) return cudaErrorInvalidValue;  // n_pad too large
  int occ = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, two_loop_kernel, kThreads,
                                                         slice1 * sizeof(float))) != cudaSuccess) return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  int grid = occ * sms;
  const int slices = ceil_div(n_pad, kSliceUnit);
  if (grid > slices) grid = slices;
  // A grid below one block per SM gets bigger slices, one block per SM.
  const int slice = ceil_div(ceil_div(n_pad, grid), 4) * 4;
  if (slice * (int)sizeof(float) > max_dyn) return cudaErrorInvalidValue;
  *grid_out = grid;
  *slice_out = slice;
  return cudaSuccess;
}

// r = H v for f32 v, S, Y, rho. `partials` holds 2 * 3 * grid floats.
// Returns the launch's cudaError_t (0 on success).
extern "C" int two_loop_f32(const void* v, const void* S, const void* Y, const void* rho,
                            const void* head, const void* count, void* out, void* partials,
                            int n_pad, int m, int grid, int slice, int clamp_gamma,
                            float gamma_min, float gamma_max, void* stream) {
  Params p;
  p.v = static_cast<const float*>(v);
  p.S = static_cast<const float*>(S);
  p.Y = static_cast<const float*>(Y);
  p.rho = static_cast<const float*>(rho);
  p.head = static_cast<const int*>(head);
  p.count = static_cast<const int*>(count);
  p.out = static_cast<float*>(out);
  p.partials = static_cast<float*>(partials);
  p.n_pad = n_pad;
  p.m = m;
  p.slice = slice;
  p.clamp_gamma = clamp_gamma;
  p.gamma_min = gamma_min;
  p.gamma_max = gamma_max;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(two_loop_kernel), dim3(grid),
                                              dim3(kThreads), args, (size_t)slice * sizeof(float),
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" const char* two_loop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
