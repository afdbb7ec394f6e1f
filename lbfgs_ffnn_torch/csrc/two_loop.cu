// L-BFGS two-loop recursion r = H v: three persistent cooperative kernels,
// each templated on the stored pair type (float or __nv_bfloat16); all
// arithmetic is f32.
//
//   backward, newest -> oldest:  a_i = rho_i s_i.q ;  q -= a_i y_i
//   gamma = s.y / y.y of the newest pair (1 if count == 0 or y.y <= 0;
//           with clamp_gamma: 1 if |y.y| < 1e-12, then clipped)
//   z = gamma q
//   forward, oldest -> newest:   b = rho_i y_i.z ;  z += (a_i - b) s_i
//
// They replace the TPU kernels of lbfgs_ffnn_tpu/ops/pallas_two_loop.py:
//   * kResident replaces _kernel_resident (K1), which pulls the whole (S, Y)
//     history into VMEM with two bulk DMAs and runs both passes from there.
//     Here every block copies its column slice of all `count` pairs into
//     shared memory with cp.async at the start, then runs the 2*count stages
//     from shared memory. It takes rings whose slices fit: about 29 MB of
//     q + S + Y over a one-block-per-SM grid of an H100.
//   * kStreaming replaces _kernel (K2), which keeps q on-chip and streams the
//     (s_i, y_i) rows from HBM, double-buffered one pair ahead. Here every
//     block keeps two (s, y) slice buffers in shared memory; at the start of
//     stage t it issues the cp.async copies of stage t+1's pair into the
//     other buffer, so the HBM latency of the next pair hides behind this
//     stage's dot, grid barrier and axpy. bf16 rows arrive as 8 values per
//     16-byte copy and are upcast in registers.
//   * kBlocked replaces _kernel_blocked (K3), which keeps only the working
//     vector in VMEM and streams the rows through it in chunks, with gamma
//     precomputed outside the kernel. On Hopper the working vector alone
//     (4 bytes per element) fits the grid's shared memory up to ~7.4M
//     elements; what no longer fits at n ~ 2M is q plus K2's two staged
//     pairs. So each block keeps only its q slice in shared memory, and
//     every stage's dot and axpy sweeps read the pair's slice straight from
//     global memory with 16-byte loads (bf16: 8 values, upcast in
//     registers); nothing is staged. Gamma's s.y and y.y ride in stage 0's
//     sweep as in the other two, which reads the newest y there once more
//     (JAX's XLA prelude pays the same extra row).
//
// Shared design. One block's shared memory (227 KB) cannot hold the working
// vector (242,816 floats padded on the deep net, 971 KB), so the vector is
// split: each block owns one contiguous slice of q (later z) in shared
// memory for the whole call, and the 2*count sequential stages run inside
// one launch. A stage is: partial dot over the block's slice -> block
// reduction -> partials[block] -> grid.sync() -> every block sums all
// partials in the same fixed order (so every block, and every run, gets the
// bitwise same scalar; no atomics) -> local axpy on the slice. The newest
// pair's s.y and y.y ride along in the first stage. Each thread copies,
// reads and writes only its own 16-byte chunks of every shared buffer, so
// the buffers need no block barrier: a thread's cp.async wait covers all it
// reads.
//
// Bound on this card: each call reads 2*count*n_pad*sizeof(pair) bytes of
// history once, plus v and out: at m = 100 on the deep net (n_pad 242,816)
// 196.2 MB f32 = 58.6 us, 99.1 MB bf16 = 29.6 us at 3.35 TB/s. A ring
// larger than the 50 MB L2 is read twice by any streaming schedule (the
// forward pass needs every pair again): 117 us there, and at m = 50,
// n = 2M f32 (800 MB) 482 us against 244 us read once. The 2*count grid
// barriers (a few us each) are expected to set the pace at small n.
//
// The grid is sized so that every block is resident at once (a condition
// of grid.sync()): occupancy x SMs, capped by the number of 1024-element
// slices. head, count and rho are read on the device; the host never reads
// them. Launches on the caller's stream; allocates nothing.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSliceUnit = kThreads * 4;  // grid cap: one float4 of q per thread
constexpr int kSliceAlign = 8;            // slices hold whole 16-byte chunks of f32 and bf16
constexpr int kMaxM = 1024;               // alphas live in shared memory
constexpr int kNumPartials = 3;           // values reduced per stage (at most)

enum Kind { kResident = 0, kStreaming = 1, kBlocked = 2 };

struct Params {
  const float* v;      // (n_pad,)
  const void* S;       // (m, n_pad) pair type
  const void* Y;       // (m, n_pad) pair type
  const float* rho;    // (m,)
  const int* head;     // scalar
  const int* count;    // scalar
  float* out;          // (n_pad,)
  float* partials;     // (2, kNumPartials, gridDim.x) scratch
  int n_pad;
  int m;
  int slice;           // elements per block, a multiple of kSliceAlign
  int clamp_gamma;
  float gamma_min;
  float gamma_max;
};

// One 16-byte chunk of stored pair values, upcast to f32.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float (&f)[kN]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[kN]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 w = __bfloat1622float2(h[k]);
      f[2 * k] = w.x;
      f[2 * k + 1] = w.y;
    }
  }
};

template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + k);
    f[k] = x.x; f[k + 1] = x.y; f[k + 2] = x.z; f[k + 3] = x.w;
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4)
    *reinterpret_cast<float4*>(p + k) = make_float4(f[k], f[k + 1], f[k + 2], f[k + 3]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

template <typename T, int kKind>
__global__ void __launch_bounds__(kThreads) two_loop_kernel(Params p) {
  using C = Chunk<T>;
  constexpr int kN = C::kN;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem[];  // q slice, then the (s, y) slice buffers
  __shared__ float alphas[kMaxM];
  __shared__ float red[kNumPartials * kWarps];
  __shared__ float bcast[kNumPartials];

  const int slice = p.slice;
  const int start = blockIdx.x * slice;
  const int nchunk = max(0, min(slice, p.n_pad - start)) / kN;
  const int m = p.m;
  const int head = *p.head;
  const int count = min(*p.count, m);  // <= m by the ring's invariant
  float* q = reinterpret_cast<float*>(smem);
  T* rows = reinterpret_cast<T*>(q + slice);  // staged pairs (not kBlocked)
  const T* S = static_cast<const T*>(p.S) + start;
  const T* Y = static_cast<const T*>(p.Y) + start;

  // Stage t of 2*count runs the backward pass on the t-th newest pair, then
  // the forward pass from the oldest pair up: stage t uses pair j(t).
  auto pair_of = [&](int t) { return t < count ? t : 2 * count - 1 - t; };
  auto slot = [&](int j) { return ((head - 1 - j) % m + m) % m; };  // j-th newest
  // Offset of stage t's row in S and Y: rows reach 2 * 50 * 4M * 4 bytes.
  auto row_off = [&](int t) { return (size_t)slot(pair_of(t)) * p.n_pad; };
  // Shared (s, y) slices of stage t's pair: s at +0, y at +slice.
  auto buf = [&](int t) -> T* {
    const int b = kKind == kResident ? pair_of(t) : (t & 1);
    return rows + (size_t)b * 2 * slice;
  };
  // Copy stage t's pair into its buffer: this thread's chunks, one group.
  auto fetch = [&](int t) {
    const size_t off = row_off(t);
    T* dst = buf(t);
    for (int c = threadIdx.x; c < nchunk; c += kThreads) {
      cp_async16(dst + c * kN, S + off + c * kN);
      cp_async16(dst + slice + c * kN, Y + off + c * kN);
    }
    cp_async_commit();
  };

  if constexpr (kKind == kResident) {
    for (int t = 0; t < count; ++t) fetch(t);
  } else if constexpr (kKind == kStreaming) {
    if (count > 0) fetch(0);
  }
  for (int c = threadIdx.x; c < nchunk; c += kThreads) {
    float x[kN];
    load_f32(p.v + start + c * kN, x);
    store_f32(q + c * kN, x);
  }

  int pbuf = 0;
  float gamma = 1.f;
  for (int t = 0; t < 2 * count; ++t) {
    const bool bwd = t < count;
    const int i = slot(pair_of(t));
    if constexpr (kKind == kStreaming) {
      if (t + 1 < 2 * count) {
        fetch(t + 1);  // the next pair streams in behind this stage
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else if constexpr (kKind == kResident) {
      if (t == 0) cp_async_wait<0>();
    }
    // kBlocked reads this stage's slices from global memory; the others
    // from their shared buffers.
    const T* s_row = kKind == kBlocked ? S + row_off(t) : buf(t);
    const T* y_row = kKind == kBlocked ? Y + row_off(t) : s_row + slice;
    const T* dot_row = bwd ? s_row : y_row;   // backward s.q, forward y.z
    const T* axpy_row = bwd ? y_row : s_row;  // backward y, forward s

    float dot;
    if (t == 0) {  // the newest pair: s.q, s.y and y.y in one sweep
      float vals[3] = {0.f, 0.f, 0.f};
      for (int c = threadIdx.x; c < nchunk; c += kThreads) {
        float s[kN], y[kN], x[kN];
        C::load(s_row + c * kN, s);
        C::load(y_row + c * kN, y);
        load_f32(q + c * kN, x);
        float sq = 0.f, sy = 0.f, yy = 0.f;
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          sq += s[k] * x[k];
          sy += s[k] * y[k];
          yy += y[k] * y[k];
        }
        vals[0] += sq;
        vals[1] += sy;
        vals[2] += yy;
      }
      grid_sum<3>(vals, p, pbuf, grid, red, bcast);
      dot = vals[0];
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
      for (int c = threadIdx.x; c < nchunk; c += kThreads) {
        float r[kN], x[kN];
        C::load(dot_row + c * kN, r);
        load_f32(q + c * kN, x);
        float d = 0.f;
#pragma unroll
        for (int k = 0; k < kN; ++k) d += r[k] * x[k];
        vals[0] += d;
      }
      grid_sum<1>(vals, p, pbuf, grid, red, bcast);
      dot = vals[0];
    }
    pbuf ^= 1;

    float coef;
    if (bwd) {
      const float a = p.rho[i] * dot;
      if (threadIdx.x == 0) alphas[count - 1 - t] = a;
      coef = -a;
    } else {
      coef = alphas[t - count] - p.rho[i] * dot;
    }
    const float scale = t == count - 1 ? gamma : 1.f;  // end of backward: z = gamma q
    for (int c = threadIdx.x; c < nchunk; c += kThreads) {
      float r[kN], x[kN];
      C::load(axpy_row + c * kN, r);
      load_f32(q + c * kN, x);
#pragma unroll
      for (int k = 0; k < kN; ++k) x[k] = (x[k] + coef * r[k]) * scale;
      store_f32(q + c * kN, x);
    }
    if (t == count - 1) __syncthreads();  // alphas (thread 0) are read by all
  }

  for (int c = threadIdx.x; c < nchunk; c += kThreads) {
    float x[kN];
    load_f32(q + c * kN, x);
    store_f32(p.out + start + c * kN, x);
  }
}

static int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T>
static const void* kernel_of_type(int kind) {
  switch (kind) {
    case kResident: return reinterpret_cast<const void*>(two_loop_kernel<T, kResident>);
    case kStreaming: return reinterpret_cast<const void*>(two_loop_kernel<T, kStreaming>);
    case kBlocked: return reinterpret_cast<const void*>(two_loop_kernel<T, kBlocked>);
    default: return nullptr;
  }
}

static const void* kernel_of(int kind, int pair_bytes) {
  if (pair_bytes == 4) return kernel_of_type<float>(kind);
  if (pair_bytes == 2) return kernel_of_type<__nv_bfloat16>(kind);
  return nullptr;
}

// Dynamic shared memory per element of a block's slice: q, plus all m
// pairs (resident), two pairs (streaming) or none (blocked) of (s, y).
static size_t smem_per_element(int kind, int pair_bytes, int m) {
  const size_t pairs = kind == kResident ? 2 * (size_t)m : kind == kStreaming ? 4 : 0;
  return sizeof(float) + pairs * pair_bytes;
}

// Launch geometry of `kind` for (pair_bytes, n_pad, m) on the current
// device: the grid, the elements per block and the dynamic shared memory in
// bytes. Returns a cudaError_t; cudaErrorInvalidValue when the slices of a
// one-block-per-SM grid do not fit a block's shared memory.
extern "C" int two_loop_config(int kind, int pair_bytes, int n_pad, int m, int* grid_out,
                               int* slice_out, int* smem_out) {
  const void* kern = kernel_of(kind, pair_bytes);
  if (kern == nullptr || n_pad <= 0 || n_pad % kSliceAlign != 0 || m <= 0 || m > kMaxM)
    return cudaErrorInvalidValue;
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
  if ((e = cudaFuncGetAttributes(&fa, kern)) != cudaSuccess) return e;
  const int max_dyn = optin - (int)fa.sharedSizeBytes;
  if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_dyn)) != cudaSuccess)
    return e;
  const size_t per = smem_per_element(kind, pair_bytes, m);
  // Occupancy at the largest slice any grid of >= one block per SM uses.
  const int slice1 = ceil_div(ceil_div(n_pad, sms), kSliceAlign) * kSliceAlign;
  if ((size_t)slice1 * per > (size_t)max_dyn) return cudaErrorInvalidValue;
  int occ = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, slice1 * per)) != cudaSuccess)
    return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  int grid = occ * sms;
  const int slices = ceil_div(n_pad, kSliceUnit);
  if (grid > slices) grid = slices;
  // A grid below one block per SM gets bigger slices, one block per SM.
  const int slice = ceil_div(ceil_div(n_pad, grid), kSliceAlign) * kSliceAlign;
  if ((size_t)slice * per > (size_t)max_dyn) return cudaErrorInvalidValue;
  *grid_out = grid;
  *slice_out = slice;
  *smem_out = (int)(slice * per);
  return cudaSuccess;
}

// r = H v with f32 v, rho, out and (S, Y) of pair_bytes 4 (f32) or 2
// (bf16). `partials` holds 2 * 3 * grid floats. Returns the launch's
// cudaError_t (0 on success).
extern "C" int two_loop_launch(int kind, int pair_bytes, const void* v, const void* S,
                               const void* Y, const void* rho, const void* head,
                               const void* count, void* out, void* partials, int n_pad, int m,
                               int grid, int slice, int smem, int clamp_gamma, float gamma_min,
                               float gamma_max, void* stream) {
  const void* kern = kernel_of(kind, pair_bytes);
  if (kern == nullptr) return cudaErrorInvalidValue;
  Params p;
  p.v = static_cast<const float*>(v);
  p.S = S;
  p.Y = Y;
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
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(kThreads), args, (size_t)smem,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" const char* two_loop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
