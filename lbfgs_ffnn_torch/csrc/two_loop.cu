// L-BFGS two-loop recursion r = H v: three persistent cooperative kernels,
// each templated on the stored pair type (float or __nv_bfloat16); all
// arithmetic is f32. K1 is two_loop_resident_kernel<T, kStamps> (the compact
// form, two grid reductions per call), K2 two_loop_grouped_kernel<T, K> (K
// pairs per grid reduction), K3 two_loop_blocked_kernel<T>.
//
//   backward, newest -> oldest:  a_i = rho_i s_i.q ;  q -= a_i y_i
//   gamma = s.y / y.y of the newest pair (1 if count == 0 or y.y <= 0;
//           with clamp_gamma: 1 if |y.y| < 1e-12, then clipped)
//   z = gamma q
//   forward, oldest -> newest:   b = rho_i y_i.z ;  z += (a_i - b) s_i
//
// They replace the TPU kernels of lbfgs_ffnn_tpu/ops/pallas_two_loop.py:
//   * kResident (two_loop_resident_kernel) replaces _kernel_resident (K1),
//     which pulls the whole (S, Y) history into VMEM with two bulk DMAs and
//     runs both passes from there, one sequential stage per pair. A stage
//     loop pays one grid reduction per stage, 2*count per call: at MNIST
//     m = 10 (n = 101,770, 100 blocks, one float4 per thread) those 20
//     reductions were nearly all of its 48.9 us of device time on an H100,
//     against the 2.7 us the ring's 8.1 MB take from HBM. With the whole ring on chip
//     the recursion collapses to the compact form (two_loop_compact in
//     ops/two_loop.py), in logical order l, oldest first:
//       c_l = s_l.v,  M_lj = s_l.y_j (l < j),  the newest s.y and y.y
//         -> reduction 1 (c(c+1)/2 + 2 values: 57 at count 10)
//       a_l = rho_l (c_l - sum_{j>l} M_lj a_j), gamma    (warp 0)
//       z0 = gamma (v - sum a_l y_l),  d_l = y_l.z0
//         -> reduction 2 (c values)
//       b_l = rho_l (d_l + sum_{j<l} M_jl (a_j - b_j))   (warp 0)
//       r = z0 + sum (a_l - b_l) s_l
//     Both recurrences read only M's strict upper triangle: two grid
//     reductions per call at any count >= 1, none at count 0. Every block
//     has the TMA unit copy its column slices of the live pairs into shared
//     memory (one bulk request per row slice, four pairs to an mbarrier),
//     and the first sweep starts on the oldest pairs while the rest land.
//     It takes the (l, j) products in 4 x 4 tiles, one warp to a tile over
//     all the block's chunks, each tile's 16 sums summed over the warp at
//     once by a butterfly (warp_sum16), so no thread holds more than 16
//     sums; grid_sum_values sums each value's partials in one fixed order. The cap kResidentMaxM bounds the first
//     reduction's width; rings with more pairs go to K2. It takes rings
//     whose slices fit: about 29 MB of q + S + Y over a one-block-per-SM
//     grid of an H100.
//   * kStreaming (two_loop_grouped_kernel) replaces
//     pallas_two_loop.py::_kernel (K2), which keeps q on-chip and streams the
//     (s_i, y_i) rows from HBM one pair ahead, one sequential stage per
//     pair. On one TPU core a stage is cheap; across 132 SMs every stage
//     needs a grid-wide reduction (block reduction, grid.sync(), a read of
//     every block's partial, a second block reduction, a broadcast), ~3 us
//     against the 0.6 us its bytes take at the deep m=100 ring. So here the
//     grid reduction, not HBM, bounds the kernel, and one reduction serves
//     a group of K consecutive pairs: within a group every coefficient
//     follows from dots against the vector at the group's start and the
//     group's cross dots (two_loop_grouped in ops/two_loop.py has the
//     algebra),
//       backward  a_j = rho_j (s_j.q0 - sum_{l<j} a_l s_j.y_l),
//       forward   b_j = rho_j (y_j.z0 + sum_{l<j} (a_l - b_l) y_j.s_l),
//     K + K(K-1)/2 values per reduction. Every block keeps two group
//     buffers of K (s, y) slice pairs in shared memory; one sweep applies
//     group g's update and accumulates group g+1's dots against the updated
//     chunk; then the cp.async copies of group g+2 go into the buffer g
//     freed and land behind g+1's grid reduction. That reduction
//     (grid_sum_wide) takes all of a group's values at once. Thread 0 of
//     every block solves a group's K-term triangular recursion in one fixed
//     order, so all blocks get bitwise-equal coefficients. bf16 rows arrive
//     as 8 values per 16-byte copy and are upcast in registers.
//   * kBlocked (two_loop_blocked_kernel) replaces _kernel_blocked (K3),
//     which keeps only the working vector in VMEM and streams the rows
//     through it in chunks, with gamma precomputed outside the kernel. On
//     Hopper the working vector alone (4 bytes per element) fits the grid's
//     shared memory up to ~7.4M elements; what no longer fits at n ~ 2M is
//     q plus K2's two staged pairs. So each block keeps only its q slice in
//     shared memory, and every stage's dot and axpy sweeps read the pair's
//     slice from global memory with 16-byte loads (bf16: 8 values, upcast
//     in registers). Gamma's s.y and y.y ride in stage 0's sweep as in the
//     other two, which reads the newest y there once more (JAX's XLA
//     prelude pays the same extra row). _kernel_blocked overlapped its
//     stages on the TPU by issuing stage t+1's DMA before stage t's
//     compute. Here the TMA unit does the same into L2: the rows the call
//     reads form one sequence (blocked_row: stage t's dot row, then its
//     axpy row), and whenever a block starts a sweep on row u it issues
//     cp.async.bulk.prefetch.L2 for its slice of row u + d, fire-and-forget,
//     no registers or shared memory, so HBM streams the coming row through
//     the grid barrier. d (Params::prefetch, prefetch_rows in
//     ops/cuda_two_loop.py) is the most rows that fit a 4 MiB L2 budget, at
//     least 1: 1 on every m=50 ring of the large path. What bounds K3 on this
//     card (experiments/blocked_stage_study.py, n = 2M f32, PERF.md section 6): a
//     stage moves two rows, 16 MB; its sweeps alone take 7.4 us (~2.15
//     TB/s), its grid reduction alone 3.4 us, and the two overlap to 8.4 us.
//     The prefetch alone streams through the reductions at 3.06 TB/s, but in
//     the whole kernel its traffic lands beside the sweeps' own loads, not
//     in the reductions: d = 1 takes 0.8% off, d = 2 adds 3.4% and d = 4
//     47% (rows evicted before use); at 4M f32, whose 16 MB rows overrun
//     the budget, d = 1 adds 29%. On the 4 MB bf16 rows at 2M it takes 10%
//     off.
//
// Shared design. One block's shared memory (227 KB) cannot hold the working
// vector (242,816 floats padded on the deep net, 971 KB), so the vector is
// split: each block owns one contiguous slice of q (later z) in shared
// memory for the whole call, and the 2*count sequential stages (K1: its two
// sweeps with reductions and a third sweep) run inside one launch. A stage
// (in K2 a group of stages) is: partial dots over the block's slice ->
// block reduction -> partials[block] -> grid.sync() -> every block sums all
// partials in the same fixed order (so every block, and every run, gets
// the bitwise same scalars; no atomics) -> local axpy on the slice. The
// newest pair's s.y and y.y ride along in the first stage, group or sweep.
// Each thread copies, reads and writes only its own 16-byte chunks of every
// shared buffer, so the buffers need no block barrier: in K2 a thread's
// cp.async wait covers all it reads, in K1 every thread waits on the
// mbarriers its pairs' bulk copies complete on.
//
// Bound on this card: each call reads 2*count*n_pad*sizeof(pair) bytes of
// history once, plus v and out: at m = 100 on the deep net (n_pad 242,816)
// 196.2 MB f32 = 58.6 us, 99.1 MB bf16 = 29.6 us at 3.35 TB/s. A ring
// larger than the 50 MB L2 is read twice by any streaming schedule (the
// forward pass needs every pair again): 117 us there, and at m = 50,
// n = 2M f32 (800 MB) 482 us against 244 us read once. K3 runs 2*count
// grid barriers (a few us each). K2 moves the same bytes with
// 2*ceil(count/K) barriers (50 at K = 4 and 26 at K = 8 on the deep m=100
// ring, against 200 at K = 1), K1 with 2.
//
// The grid is sized so that every block is resident at once (a condition
// of grid.sync()): occupancy x SMs, capped by the number of 1024-element
// slices (for K1 at MNIST's n = 101,770: 100 blocks, faster than 132 on an
// H100). head, count and rho are read on the device; the host never reads
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
constexpr int kMaxGroup = 8;              // K2's largest group of pairs
// K1's cap on m: its first reduction carries c(c+1)/2 + 2 values, 138 at
// 16, each thread summing one value's partials (kThreads >= 138), with no
// spills in ptxas's report at either pair type.
constexpr int kResidentMaxM = 16;
constexpr int kResidentValues = kResidentMaxM * (kResidentMaxM + 1) / 2 + 2;
constexpr int kTile = 4;  // K1's first sweep: 4 x 4 (l, j) products per pass
// Values reduced per stage or group (at most): K1's first reduction at its
// cap; K2's widest is 38, its first group at K = 8.
constexpr int kNumPartials = kResidentValues;
static_assert(2 + kMaxGroup * (kMaxGroup + 1) / 2 <= kNumPartials, "K2's group is wider");
// K3's L2 prefetch: a block's slice of a row goes out in bulk requests of
// at most this many bytes, each a multiple of 16.
constexpr int kPrefetchBytes = 16 * 1024;

// kResidentStamped is K1 with block 0's phase timestamps (a study's build of
// the same kernel; the path launches kResident).
enum Kind { kResident = 0, kStreaming = 1, kBlocked = 2, kResidentStamped = 3 };
constexpr int kStamps = 9;  // K1's phase boundaries, each %globaltimer and clock64

struct Params {
  const float* v;      // (n,), zero beyond n up to n_pad
  const void* S;       // (m, n_pad) pair type
  const void* Y;       // (m, n_pad) pair type
  const float* rho;    // (m,)
  const int* head;     // scalar
  const int* count;    // scalar
  float* out;          // (n_pad,)
  float* partials;     // (2, kNumPartials, gridDim.x) scratch
  int n_pad;
  int n;               // entries of v (<= n_pad)
  int m;
  int slice;           // elements per block, a multiple of kSliceAlign
  int clamp_gamma;
  float gamma_min;
  float gamma_max;
  int prefetch;        // K3: rows of its sequence prefetched ahead into L2 (>= 1); 0 for K1, K2
  unsigned long long* stamps;  // kResidentStamped: (kStamps, 2) ns and cycles; else null
  unsigned int* launches;      // this kernel's launch counter on the device, or null
};

// One count per launch, by block 0's thread 0, on the device: a launch
// replayed from a CUDA graph counts as well as an eager one.
__device__ __forceinline__ void count_launch(const Params& p) {
  if (p.launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(p.launches, 1u);
}

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

// The TMA unit copies `bytes` (a multiple of 16) from 16-byte aligned `gmem`
// to `smem`, completing them on the mbarrier at shared address `bar`.
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem, unsigned bytes,
                                          unsigned bar) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(s), "l"(gmem), "r"(bytes), "r"(bar) : "memory");
}

// An mbarrier at shared address `bar` expecting one arrival (its thread's
// arrive.expect_tx), made visible to the TMA unit.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until phase 0 of the mbarrier at `bar` has completed.
__device__ __forceinline__ void mbar_wait_phase0(unsigned bar) {
  asm volatile("{\n"
               ".reg .pred done;\n"
               "WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
               "@!done bra WAIT;\n"
               "}\n" ::"r"(bar) : "memory");
}

// Ask the TMA unit to bring `bytes` (a multiple of 16) from 16-byte aligned
// `gmem` into L2; nothing waits for it.
__device__ __forceinline__ void prefetch_l2(const void* gmem, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
               ::"l"(__cvta_generic_to_global(gmem)), "r"(bytes) : "memory");
}

// Warp sums of NV values: red[c * kWarps + warp] = value c summed over the
// warp's lanes by a shuffle tree (the trees of all values interleave).
template <int NV>
__device__ __forceinline__ void warp_sums(const float (&vals)[NV], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    float x = vals[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[c * kWarps + warp] = x;
  }
}

// Sum NV per-block values over the whole grid (K3: 3 in stage 0, then 1;
// K2: a group's dots, up to 38). Each step takes all
// values at once: thread c adds value c's warp sums into the block's
// partial, and after grid.sync() thread t reads block t's partials of all
// values with independent loads, then the same two steps sum them. (Taking
// one value after another, each value's partials read from L2 in a loop of
// its own, cost ~0.6 us per value on an H100.) Every block adds in the same
// fixed order and returns bitwise-equal totals. `buf` alternates between
// reductions: a block may write the next one's partials before a slower
// block has read this one's.
template <int NV>
__device__ void grid_sum_wide(float (&vals)[NV], const Params& p, int buf,
                              cg::grid_group& grid, float* red, float* bcast) {
  static_assert(NV <= kNumPartials && NV <= kThreads, "too many values");
  const int nblk = gridDim.x;
  const int c = threadIdx.x;  // the value this thread adds up, if c < NV
  float* part = p.partials + (size_t)buf * kNumPartials * nblk;
  auto add_warps = [&]() {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[c * kWarps + w];
    return s;
  };
  warp_sums<NV>(vals, red);
  __syncthreads();
  if (c < NV) __stcg(part + c * nblk + blockIdx.x, add_warps());
  grid.sync();  // also orders this block's reads of red before its next writes
  float acc[NV] = {};
  for (int b = threadIdx.x; b < nblk; b += kThreads) {
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] += __ldcg(part + v * nblk + b);
  }
  warp_sums<NV>(acc, red);
  __syncthreads();
  if (c < NV) bcast[c] = add_warps();
  __syncthreads();
#pragma unroll
  for (int v = 0; v < NV; ++v) vals[v] = bcast[v];
}

// The u-th row K3 reads, in order: stage t = u / 2's dot row (u even),
// then its axpy row. Stage t runs the t-th newest pair in the backward pass
// (t < count), then the pairs back from the oldest; its dot row is s
// backward and y forward, its axpy row the other one. Returns the pair's
// ring slot; *is_y says whether the row is y (else s).
__host__ __device__ inline int blocked_row(int u, int head, int count, int m, bool* is_y) {
  const int t = u >> 1;
  const bool bwd = t < count;
  const int j = bwd ? t : 2 * count - 1 - t;
  *is_y = ((u & 1) == 0) != bwd;
  return ((head - 1 - j) % m + m) % m;
}

// The 2*count stages of K3 on this block's slice q of nchunk chunks,
// one grid reduction each. row(u) is the block's slice of the u-th row of
// blocked_row's sequence, wherever the kernel keeps it; starts(u) is told
// before each sweep which row it starts on.
template <typename T, typename Row, typename Starts>
__device__ void run_stages(const Params& p, float* q, int nchunk, int head, int count,
                           cg::grid_group& grid, Row row, Starts starts) {
  using C = Chunk<T>;
  constexpr int kN = C::kN;
  __shared__ float alphas[kMaxM];
  __shared__ float red[3 * kWarps];
  __shared__ float bcast[3];

  int pbuf = 0;
  float gamma = 1.f;
  for (int t = 0; t < 2 * count; ++t) {
    const bool bwd = t < count;
    bool is_y;
    const int i = blocked_row(2 * t, head, count, p.m, &is_y);  // the stage's slot
    const T* dot_row = row(2 * t);       // backward s.q, forward y.z
    const T* axpy_row = row(2 * t + 1);  // backward y, forward s

    starts(2 * t);
    float dot;
    if (t == 0) {  // the newest pair: s.q, s.y and y.y in one sweep
      float vals[3] = {0.f, 0.f, 0.f};
      for (int c = threadIdx.x; c < nchunk; c += kThreads) {
        float s[kN], y[kN], x[kN];
        C::load(dot_row + c * kN, s);
        C::load(axpy_row + c * kN, y);
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
      grid_sum_wide<3>(vals, p, pbuf, grid, red, bcast);
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
      grid_sum_wide<1>(vals, p, pbuf, grid, red, bcast);
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
    starts(2 * t + 1);
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
}

// This block's slice of v into q (zero past v's n entries, so the caller
// need not pad v), and of q into out at the end.
template <int kN>
__device__ __forceinline__ void load_q(const Params& p, float* q, int start, int nchunk) {
  for (int c = threadIdx.x; c < nchunk; c += kThreads) {
    const int e = start + c * kN;
    float x[kN];
    if (e + kN <= p.n) {
      load_f32(p.v + e, x);
    } else {
#pragma unroll
      for (int k = 0; k < kN; ++k) x[k] = e + k < p.n ? p.v[e + k] : 0.f;
    }
    store_f32(q + c * kN, x);
  }
}

template <int kN>
__device__ __forceinline__ void store_q(const Params& p, const float* q, int start, int nchunk) {
  for (int c = threadIdx.x; c < nchunk; c += kThreads) {
    float x[kN];
    load_f32(q + c * kN, x);
    store_f32(p.out + start + c * kN, x);
  }
}

// Warp sum of x by a shuffle tree; lane 0 gets the total.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// One step of warp_sum16: each lane keeps half of its 2H values, adding the
// partner's (lane ^ 2H) copy of them: the lower lane the first H, the upper
// the last H, moved down.
template <int H>
__device__ __forceinline__ void butterfly_step(float (&v)[16], bool upper) {
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = upper ? v[k] : v[k + H];
    const float keep = upper ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
  }
}

// Warp sums of 16 values at once: a butterfly in which each lane keeps half
// of its values at every step (8 + 4 + 2 + 1 independent shuffles, then one
// more), against 16 trees of 5 dependent ones. Returns value (lane >> 1)
// summed over the warp, in one fixed order on every warp.
__device__ __forceinline__ float warp_sum16(float (&v)[16]) {
  const int lane = threadIdx.x & 31;
  butterfly_step<8>(v, lane & 16);
  butterfly_step<4>(v, lane & 8);
  butterfly_step<2>(v, lane & 4);
  butterfly_step<1>(v, lane & 2);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// K1's grid reduction of nv values whose block's partial sums are in
// red[i * slots + w], w < slots (red holds kThreads floats): thread i < nv
// adds value i's into part[block * kNumPartials + i], a block's values side
// by side. After grid.sync() thread t < g * nv (g = min(kMaxSplit,
// kThreads / nv)) sums value t % nv over blocks t / nv, t / nv + g, ... in
// order, kBatch loads at once (one L2 round trip per batch, not per
// partial; neighbouring threads read neighbouring values, so a warp's loads
// are whole 128-byte lines), then thread i < nv adds value i's g sums in
// order. Every block adds in this one order, so all get bitwise-equal
// totals, in tot[0..nv).
__device__ void grid_sum_values(int nv, int slots, float* part, cg::grid_group& grid, float* red,
                                float* tot) {
  constexpr int kMaxSplit = 8, kBatch = 32;
  const int nblk = gridDim.x;
  if (threadIdx.x < nv) {
    float s = 0.f;
    for (int w = 0; w < slots; ++w) s += red[threadIdx.x * slots + w];
    __stcg(part + (size_t)blockIdx.x * kNumPartials + threadIdx.x, s);
  }
  grid.sync();  // every block's partials are written; red is free again
  const int g = min(kMaxSplit, kThreads / nv);
  const int i = threadIdx.x % nv, k = threadIdx.x / nv;
  if (k < g) {
    float s = 0.f;
    for (int b0 = k; b0 < nblk; b0 += kBatch * g) {
      float x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int b = b0 + u * g;
        x[u] = b < nblk ? __ldcg(part + (size_t)b * kNumPartials + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s += x[u];
    }
    red[k * nv + i] = s;
  }
  __syncthreads();
  if (threadIdx.x < nv) {
    float s = 0.f;
    for (int j = 0; j < g; ++j) s += red[j * nv + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// K1's study build: block 0 records %globaltimer (ns) and clock64 at phase
// boundary k, after a block barrier, so the stamp marks the whole block.
template <bool kOn>
__device__ __forceinline__ void stamp(const Params& p, int k) {
  if (kOn) {
    __syncthreads();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      unsigned long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      p.stamps[2 * k] = ns;
      p.stamps[2 * k + 1] = clock64();
    }
  }
}

// K1 (kResident): the compact form on every block's slices of the live
// pairs in shared memory, two grid reductions per call. kStamps builds the
// study's variant, which records block 0's phase boundaries: start, copies
// issued and v loaded, sweep 1 (as the pairs land), reduction 1, backward
// recurrence, sweep 2, reduction 2, forward recurrence, sweep 3.
template <typename T, bool kStamps>
__global__ void __launch_bounds__(kThreads, 1) two_loop_resident_kernel(Params p) {
  count_launch(p);
  using C = Chunk<T>;
  constexpr int kN = C::kN;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem[];  // q slice, then the (s, y) slices of the pairs, oldest first
  // the block's partials (sweep 1's value i at i, sweep 2's d_l of warp w at
  // l * kWarps + w), then grid_sum_values' scratch
  __shared__ float red[kThreads];
  static_assert(kResidentValues <= kThreads && kResidentMaxM * kWarps <= kThreads, "red");
  __shared__ float tot[kResidentValues];  // reduction 1: c, M's upper triangle, s.y, y.y
  __shared__ float dots[kResidentMaxM];   // reduction 2: d
  __shared__ float rho[kResidentMaxM];
  __shared__ float alpha[kResidentMaxM];
  __shared__ float coef[kResidentMaxM];   // alpha - beta
  __shared__ float gamma_s;
  __shared__ alignas(8) unsigned long long landed[kResidentMaxM / kTile];  // mbarrier per group

  stamp<kStamps>(p, 0);
  const int slice = p.slice;
  const int start = blockIdx.x * slice;
  const int nchunk = max(0, min(slice, p.n_pad - start)) / kN;
  const int m = p.m;
  const int count = min(*p.count, m);  // <= m by the ring's invariant
  const int oldest = ((*p.head - count) % m + m) % m;  // physical slot of logical pair 0
  float* q = reinterpret_cast<float*>(smem);
  T* rows = reinterpret_cast<T*>(q + slice);
  const T* S = static_cast<const T*>(p.S) + start;
  const T* Y = static_cast<const T*>(p.Y) + start;

  // v first: every thread's cp.async copies of its chunks of v go out ahead
  // of the ring's bulk copies, so they do not wait behind 8 MB in HBM.
  for (int c = threadIdx.x; c < nchunk; c += kThreads) {
    const int e = start + c * kN;
    if (e + kN <= p.n) {
#pragma unroll
      for (int k = 0; k < kN; k += 4) cp_async16(q + c * kN + k, p.v + e + k);
    } else {
#pragma unroll
      for (int k = 0; k < kN; ++k) q[c * kN + k] = e + k < p.n ? p.v[e + k] : 0.f;
    }
  }
  cp_async_commit();

  // Stage the live pairs, oldest first, in groups of kTile pairs: thread 0
  // has the TMA unit copy each row's slice in one bulk request, a group's
  // requests completing on that group's mbarrier. Sweep 1 takes its tiles
  // in the order the groups land.
  const unsigned row_bytes = nchunk * 16;
  const int ngroups = row_bytes > 0 ? (count + kTile - 1) / kTile : 0;
  auto bar = [&](int g) { return static_cast<unsigned>(__cvta_generic_to_shared(&landed[g])); };
  if (threadIdx.x == 0) {
    for (int g = 0; g < ngroups; ++g) mbar_init(bar(g));
    for (int g = 0; g < ngroups; ++g) {
      const int l1 = min(count, (g + 1) * kTile);
      mbar_arrive_expect_tx(bar(g), 2 * (l1 - g * kTile) * row_bytes);
      for (int l = g * kTile; l < l1; ++l) {
        const size_t off = (size_t)((oldest + l) % m) * p.n_pad;
        T* dst = rows + (size_t)2 * l * slice;
        bulk_load(dst, S + off, row_bytes, bar(g));
        bulk_load(dst + slice, Y + off, row_bytes, bar(g));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // v is in q and the mbarriers are initialised, for every thread
  stamp<kStamps>(p, 1);
  if (count == 0) {  // r = v; every block takes this branch, so no grid barrier
    store_q<kN>(p, q, start, nchunk);
    return;
  }

  // Sweep 1, as tasks of one warp each over all the block's chunks, listed
  // in the order their pairs land: the 4 x 4 tiles (l0, j0), j0 >= l0, of
  // M_lj = s_l.y_j; then c_l = s_l.v for all l; then the newest y.y. Warp w
  // takes tasks w, w + kWarps, ...; a task's 16 sums go over the warp's
  // lanes at once (warp_sum16) into red[i]. Value index i: c_l at l, M_lj
  // (l < j) at count + j(j-1)/2 + l, then s.y and y.y. Rows past count are
  // read as row count - 1 and their products dropped, so the chunk loops
  // have no branches.
  const int nv1 = count * (count + 1) / 2 + 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = [&] {
    int t = 0;
    for (int j0 = 0; j0 < count; j0 += kTile) t += j0 / kTile + 1;
    return t;
  }();
  auto s_off = [&](int l) { return 2 * min(l, count - 1) * slice; };  // into rows
  int waited = 0;  // groups this thread knows to have landed
  auto wait_for = [&](int need) {
    for (need = min(need, ngroups); waited < need; ++waited) mbar_wait_phase0(bar(waited));
  };
  if (warp == kWarps - 1 && lane < count) rho[lane] = p.rho[(oldest + lane) % m];  // fewest tasks
  for (int task = warp, j0 = 0, l0 = 0, t = 0; task < ntiles + 2; task += kWarps) {
    float acc[16] = {};
    if (task < ntiles) {  // tile (l0, j0): advance the listing to it
      for (; t < task; ++t) {
        l0 += kTile;
        if (l0 > j0) l0 = 0, j0 += kTile;
      }
      wait_for(j0 / kTile + 1);
      int so[kTile], yo[kTile];
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        so[a] = s_off(l0 + a);
        yo[a] = s_off(j0 + a) + slice;
      }
      for (int c = lane; c < nchunk; c += 32) {
        float sv[kTile][kN];
#pragma unroll
        for (int a = 0; a < kTile; ++a) C::load(rows + so[a] + c * kN, sv[a]);
#pragma unroll
        for (int b = 0; b < kTile; ++b) {  // one column at a time: fewer live registers
          float col[kN];
          C::load(rows + yo[b] + c * kN, col);
#pragma unroll
          for (int a = 0; a < kTile; ++a) {
            float u = 0.f;
#pragma unroll
            for (int e = 0; e < kN; ++e) u += sv[a][e] * col[e];
            acc[a * kTile + b] += u;
          }
        }
      }
      const float sum = warp_sum16(acc);
      const int k = lane >> 1, l = l0 + k / kTile, j = j0 + k % kTile;
      int i = -1;  // the value this lane's sum is, if the tile holds one there
      if (l < j && j < count) i = count + j * (j - 1) / 2 + l;
      else if (l == j && j == count - 1) i = nv1 - 2;
      if ((lane & 1) == 0 && i >= 0) red[i] = sum;
    } else if (task == ntiles) {  // c_l = s_l.v, l < count <= 16
      static_assert(kResidentMaxM == 16, "the s_l.v task's sums go through warp_sum16");
      wait_for(ngroups);
      int so[kResidentMaxM];
#pragma unroll
      for (int l = 0; l < kResidentMaxM; ++l) so[l] = s_off(l);
      for (int c = lane; c < nchunk; c += 32) {
        float x[kN];
        load_f32<kN>(q + c * kN, x);
#pragma unroll
        for (int l = 0; l < kResidentMaxM; ++l) {
          float sv[kN];
          C::load(rows + so[l] + c * kN, sv);
          float u = 0.f;
#pragma unroll
          for (int e = 0; e < kN; ++e) u += sv[e] * x[e];
          acc[l] += u;
        }
      }
      const float sum = warp_sum16(acc);
      if ((lane & 1) == 0 && (lane >> 1) < count) red[lane >> 1] = sum;
    } else {  // the newest y.y
      wait_for(ngroups);
      const T* y = rows + s_off(count - 1) + slice;
      float yy = 0.f;
      for (int c = lane; c < nchunk; c += 32) {
        float col[kN];
        C::load(y + c * kN, col);
#pragma unroll
        for (int e = 0; e < kN; ++e) yy += col[e] * col[e];
      }
      yy = warp_sum(yy);
      if (lane == 0) red[nv1 - 1] = yy;
    }
  }
  for (; waited < ngroups; ++waited) mbar_wait_phase0(bar(waited));  // the sweeps below read every row
  __syncthreads();
  stamp<kStamps>(p, 2);
  grid_sum_values(nv1, 1, p.partials, grid, red, tot);
  stamp<kStamps>(p, 3);

  // Backward recurrence, newest first, and gamma: warp 0 of every block in
  // one fixed order, from bitwise-equal totals. Lane l keeps c_l minus the
  // terms of the pairs solved so far; at step j lane j's alpha_j goes to
  // every lane, and the older lanes take their term off.
  if (warp == 0) {
    float m_row[kResidentMaxM];  // M_{lane, j}, loaded at once
#pragma unroll
    for (int j = 0; j < kResidentMaxM; ++j)
      m_row[j] = lane < j && j < count ? tot[count + j * (j - 1) / 2 + lane] : 0.f;
    float r = lane < count ? tot[lane] : 0.f;
    const float rho_l = lane < count ? rho[lane] : 0.f;
#pragma unroll
    for (int j = kResidentMaxM - 1; j >= 0; --j) {
      if (j < count) {
        const float a_j = __shfl_sync(0xffffffffu, rho_l * r, j);
        if (lane == j) alpha[j] = a_j;
        r -= m_row[j] * a_j;
      }
    }
  }
  if (threadIdx.x == 0) {
    const float ys = tot[nv1 - 2], yy = tot[nv1 - 1];
    float gamma;
    if (p.clamp_gamma) {
      gamma = fabsf(yy) < 1e-12f ? 1.f : ys / (yy == 0.f ? 1.f : yy);
      gamma = gamma < p.gamma_min ? p.gamma_min : gamma;  // NaN passes through
      gamma = gamma > p.gamma_max ? p.gamma_max : gamma;
    } else {
      gamma = yy > 0.f ? ys / yy : 1.f;
    }
    gamma_s = gamma;
  }
  __syncthreads();
  stamp<kStamps>(p, 4);

  // Sweep 2: z0 = gamma (v - sum_l alpha_l y_l) into q, and d_l = y_l.z0.
  // Pairs past count are read as pair count - 1 with a zero coefficient and
  // their dots dropped, so the loop has no branches (x - 0 * y is x).
  int yo[kResidentMaxM], so[kResidentMaxM];
#pragma unroll
  for (int l = 0; l < kResidentMaxM; ++l) {
    so[l] = s_off(l);
    yo[l] = so[l] + slice;
  }
  {
    float a[kResidentMaxM], d[kResidentMaxM] = {};
#pragma unroll
    for (int l = 0; l < kResidentMaxM; ++l) a[l] = l < count ? alpha[l] : 0.f;
    const float gamma = gamma_s;
    for (int c = threadIdx.x; c < nchunk; c += kThreads) {
      float x[kN];
      load_f32<kN>(q + c * kN, x);
#pragma unroll
      for (int l = 0; l < kResidentMaxM; ++l) {
        float r[kN];
        C::load(rows + yo[l] + c * kN, r);
#pragma unroll
        for (int e = 0; e < kN; ++e) x[e] -= a[l] * r[e];
      }
#pragma unroll
      for (int e = 0; e < kN; ++e) x[e] *= gamma;
      store_f32<kN>(q + c * kN, x);
#pragma unroll
      for (int l = 0; l < kResidentMaxM; ++l) {
        float r[kN];
        C::load(rows + yo[l] + c * kN, r);
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < kN; ++e) t += r[e] * x[e];
        d[l] += t;
      }
    }
    static_assert(kResidentMaxM == 16, "d goes through warp_sum16");
    const float sum = warp_sum16(d);
    const int l = lane >> 1;
    if ((lane & 1) == 0 && l < count) red[l * kWarps + warp] = sum;
  }
  __syncthreads();
  stamp<kStamps>(p, 5);
  grid_sum_values(count, kWarps, p.partials + (size_t)kNumPartials * gridDim.x, grid, red, dots);
  stamp<kStamps>(p, 6);

  // Forward recurrence, oldest first, coef = alpha - beta: warp 0, lane l
  // keeping d_l plus the terms of the pairs solved so far.
  if (warp == 0) {
    float m_col[kResidentMaxM];  // M_{j, lane}, loaded at once
#pragma unroll
    for (int j = 0; j < kResidentMaxM; ++j)
      m_col[j] = j < lane && lane < count ? tot[count + lane * (lane - 1) / 2 + j] : 0.f;
    float r = lane < count ? dots[lane] : 0.f;
    const float rho_l = lane < count ? rho[lane] : 0.f;
    const float a_l = lane < count ? alpha[lane] : 0.f;
#pragma unroll
    for (int j = 0; j < kResidentMaxM; ++j) {
      if (j < count) {
        const float c_j = __shfl_sync(0xffffffffu, a_l - rho_l * r, j);
        if (lane == j) coef[j] = c_j;
        r += m_col[j] * c_j;
      }
    }
  }
  __syncthreads();
  stamp<kStamps>(p, 7);

  // Sweep 3: r = z0 + sum_l coef_l s_l, straight to out (no branches, as
  // in sweep 2).
  float cf[kResidentMaxM];
#pragma unroll
  for (int l = 0; l < kResidentMaxM; ++l) cf[l] = l < count ? coef[l] : 0.f;
  for (int c = threadIdx.x; c < nchunk; c += kThreads) {
    float x[kN];
    load_f32<kN>(q + c * kN, x);
#pragma unroll
    for (int l = 0; l < kResidentMaxM; ++l) {
      float r[kN];
      C::load(rows + so[l] + c * kN, r);
#pragma unroll
      for (int e = 0; e < kN; ++e) x[e] += cf[l] * r[e];
    }
    store_f32<kN>(p.out + start + c * kN, x);
  }
  stamp<kStamps>(p, 8);
}

// K3 (kBlocked): only q in shared memory; the rows are read from global
// memory, each prefetched into L2 p.prefetch rows of the sequence ahead.
template <typename T>
__global__ void __launch_bounds__(kThreads) two_loop_blocked_kernel(Params p) {
  count_launch(p);
  constexpr int kN = Chunk<T>::kN;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem[];  // q slice

  const int slice = p.slice;
  const int start = blockIdx.x * slice;
  const int nchunk = max(0, min(slice, p.n_pad - start)) / kN;
  const int m = p.m;
  const int head = *p.head;
  const int count = min(*p.count, m);  // <= m by the ring's invariant
  const int nrows = 4 * count;         // two rows per stage
  const int d = min(p.prefetch, nrows);  // a larger distance prefetches no more
  float* q = reinterpret_cast<float*>(smem);
  const T* S = static_cast<const T*>(p.S) + start;
  const T* Y = static_cast<const T*>(p.Y) + start;

  auto row = [&](int u) -> const T* {
    bool is_y;
    const int i = blocked_row(u, head, count, m, &is_y);
    return (is_y ? Y : S) + (size_t)i * p.n_pad;  // rows reach 2 * 50 * 7.4M * 4 bytes
  };
  // This block's slice of row u into L2, in requests of up to
  // kPrefetchBytes spread over the threads; nothing past the sequence.
  auto prefetch = [&](int u) {
    if (u >= nrows) return;
    const char* src = reinterpret_cast<const char*>(row(u));
    const int bytes = nchunk * 16;  // whole 16-byte chunks
    for (int b = threadIdx.x * kPrefetchBytes; b < bytes; b += kThreads * kPrefetchBytes)
      prefetch_l2(src + b, min(kPrefetchBytes, bytes - b));
  };

  for (int u = 0; u < d; ++u) prefetch(u);
  load_q<kN>(p, q, start, nchunk);
  run_stages<T>(p, q, nchunk, head, count, grid, row, [&](int u) { prefetch(u + d); });
  store_q<kN>(p, q, start, nchunk);
}

// K2 (kStreaming): groups of K pairs, one grid reduction per group.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads) two_loop_grouped_kernel(Params p) {
  count_launch(p);
  using C = Chunk<T>;
  constexpr int kN = C::kN;
  constexpr int kV = K * (K + 1) / 2;  // a group's dots: K with the vector, then the cross dots
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem[];  // q slice, then two buffers of K (s, y) slice pairs
  __shared__ float alphas[kMaxM];
  __shared__ float coefs[K];
  __shared__ float red[(kV + 2) * kWarps];
  __shared__ float bcast[kV + 2];

  const int slice = p.slice;
  const int start = blockIdx.x * slice;
  const int nchunk = max(0, min(slice, p.n_pad - start)) / kN;
  const int m = p.m;
  const int head = *p.head;
  const int count = min(*p.count, m);  // <= m by the ring's invariant
  const int per_pass = (count + K - 1) / K;
  const int ngroups = 2 * per_pass;
  float* q = reinterpret_cast<float*>(smem);
  T* rows = reinterpret_cast<T*>(q + slice);
  const T* S = static_cast<const T*>(p.S) + start;
  const T* Y = static_cast<const T*>(p.Y) + start;

  // Group g of ngroups takes stages first(g) .. first(g) + len(g) - 1 of
  // its pass, backward (g < per_pass) from the newest pair, forward from
  // the oldest; the last group of a pass takes what is left.
  auto first = [&](int g) { return (g < per_pass ? g : g - per_pass) * K; };
  auto len = [&](int g) { return min(K, count - first(g)); };
  auto pair_of = [&](int g, int l) {  // the j-th newest pair is group g's l-th
    const int u = first(g) + l;
    return g < per_pass ? u : count - 1 - u;
  };
  auto slot = [&](int j) { return ((head - 1 - j) % m + m) % m; };
  // Shared (s, y) slices of group g's l-th pair: s at +0, y at +slice.
  auto staged = [&](int g, int l) -> T* {
    return rows + (size_t)((g & 1) * K + l) * 2 * slice;
  };
  // Copy group g's pairs into its buffer: this thread's chunks, one
  // cp.async group; the missing pairs of a last group are not fetched.
  auto fetch = [&](int g) {
    for (int l = 0; l < len(g); ++l) {
      const size_t off = (size_t)slot(pair_of(g, l)) * p.n_pad;  // rows reach 1.6 GB
      T* dst = staged(g, l);
      for (int c = threadIdx.x; c < nchunk; c += kThreads) {
        cp_async16(dst + c * kN, S + off + c * kN);
        cp_async16(dst + slice + c * kN, Y + off + c * kN);
      }
    }
    cp_async_commit();
  };
  // Add chunk c's share of group h's dots to vals, x being the working
  // vector there: backward s_j.q and s_j.y_l, forward y_j.z and y_j.s_l
  // (l < j), the cross dot (j, l) at K + j(j-1)/2 + l.
  auto add_dots = [&](int h, int c, const float (&x)[kN], float (&vals)[kV]) {
    const bool bwd = h < per_pass;
    const int kh = len(h);
    float other[K][kN];  // backward y_l, forward s_l
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < kh) {
        const T* row = staged(h, j);
        float d[kN];
        C::load((bwd ? row : row + slice) + c * kN, d);
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < kN; ++e) t += d[e] * x[e];
        vals[j] += t;
#pragma unroll
        for (int l = 0; l < j; ++l) {
          float u = 0.f;
#pragma unroll
          for (int e = 0; e < kN; ++e) u += d[e] * other[l][e];
          vals[K + j * (j - 1) / 2 + l] += u;
        }
        if (j + 1 < kh) C::load((bwd ? row + slice : row) + c * kN, other[j]);
      }
    }
  };

  if (ngroups > 0) {  // ngroups is even: two groups stream in at once
    fetch(0);
    fetch(1);
  }
  load_q<kN>(p, q, start, nchunk);

  float gamma = 1.f;
  float dots[kV];  // the current group's dots, summed over the grid
  float rho_g[K];  // thread 0: rho of the current group's pairs
  auto load_rho = [&](int g) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int l = 0; l < K; ++l) rho_g[l] = l < len(g) ? p.rho[slot(pair_of(g, l))] : 0.f;
    }
  };
  if (ngroups > 0) {  // group 0's dots with v, and the newest pair's s.y and y.y
    cp_async_wait<1>();
    float vals[kV] = {};
    float sy_acc = 0.f, yy_acc = 0.f;
    for (int c = threadIdx.x; c < nchunk; c += kThreads) {
      float x[kN], s[kN], y[kN];
      load_f32(q + c * kN, x);
      add_dots(0, c, x, vals);
      C::load(staged(0, 0) + c * kN, s);
      C::load(staged(0, 0) + slice + c * kN, y);
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        a += s[e] * y[e];
        b += y[e] * y[e];
      }
      sy_acc += a;
      yy_acc += b;
    }
    float all[kV + 2];
#pragma unroll
    for (int i = 0; i < kV; ++i) all[i] = vals[i];
    all[kV] = sy_acc;
    all[kV + 1] = yy_acc;
    load_rho(0);
    grid_sum_wide<kV + 2>(all, p, 0, grid, red, bcast);
#pragma unroll
    for (int i = 0; i < kV; ++i) dots[i] = all[i];
    const float ys = all[kV], yy = all[kV + 1];
    if (p.clamp_gamma) {
      gamma = fabsf(yy) < 1e-12f ? 1.f : ys / (yy == 0.f ? 1.f : yy);
      gamma = gamma < p.gamma_min ? p.gamma_min : gamma;  // NaN passes through
      gamma = gamma > p.gamma_max ? p.gamma_max : gamma;
    } else {
      gamma = yy > 0.f ? ys / yy : 1.f;
    }
  }

  int pbuf = 1;
  for (int g = 0; g < ngroups; ++g) {
    const bool bwd = g < per_pass;
    const int kg = len(g);
    if (threadIdx.x == 0) {  // group g's coefficients, in one fixed order
      float cf[K];
#pragma unroll
      for (int l = 0; l < K; ++l) {
        if (l < kg) {
          float acc = dots[l];
#pragma unroll
          for (int b = 0; b < l; ++b) acc += cf[b] * dots[K + l * (l - 1) / 2 + b];
          const int j = pair_of(g, l);
          if (bwd) {  // cf = -alpha
            const float a = rho_g[l] * acc;
            alphas[j] = a;
            cf[l] = -a;
          } else {  // cf = alpha - beta
            cf[l] = alphas[j] - rho_g[l] * acc;
          }
          coefs[l] = cf[l];
        }
      }
    }
    __syncthreads();  // coefs (thread 0) are read by all
    float cf[K];
#pragma unroll
    for (int l = 0; l < K; ++l) cf[l] = l < kg ? coefs[l] : 0.f;

    const bool more = g + 1 < ngroups;
    if (more) cp_async_wait<0>();  // group g+1, the one copy in flight
    const float scale = g == per_pass - 1 ? gamma : 1.f;  // end of backward: z = gamma q
    float vals[kV] = {};
    for (int c = threadIdx.x; c < nchunk; c += kThreads) {
      float x[kN];
      load_f32(q + c * kN, x);
#pragma unroll
      for (int l = 0; l < K; ++l) {
        if (l < kg) {  // backward q += cf y, forward z += cf s
          float r[kN];
          const T* row = staged(g, l);
          C::load((bwd ? row + slice : row) + c * kN, r);
#pragma unroll
          for (int e = 0; e < kN; ++e) x[e] += cf[l] * r[e];
        }
      }
#pragma unroll
      for (int e = 0; e < kN; ++e) x[e] *= scale;
      store_f32(q + c * kN, x);
      if (more) add_dots(g + 1, c, x, vals);
    }
    if (g + 2 < ngroups) fetch(g + 2);  // into the buffer group g freed
    if (more) {
      load_rho(g + 1);
      grid_sum_wide<kV>(vals, p, pbuf, grid, red, bcast);
      pbuf ^= 1;
#pragma unroll
      for (int i = 0; i < kV; ++i) dots[i] = vals[i];
    }
  }
  store_q<kN>(p, q, start, nchunk);
}

static int ceil_div(int a, int b) { return (a + b - 1) / b; }

static bool is_resident(int kind) { return kind == kResident || kind == kResidentStamped; }

template <typename T>
static const void* kernel_of_type(int kind, int group) {
  if (kind == kStreaming) {
    switch (group) {
      case 1: return reinterpret_cast<const void*>(two_loop_grouped_kernel<T, 1>);
      case 2: return reinterpret_cast<const void*>(two_loop_grouped_kernel<T, 2>);
      case 4: return reinterpret_cast<const void*>(two_loop_grouped_kernel<T, 4>);
      case 8: return reinterpret_cast<const void*>(two_loop_grouped_kernel<T, 8>);
      default: return nullptr;
    }
  }
  if (group != 1) return nullptr;
  switch (kind) {
    case kResident: return reinterpret_cast<const void*>(two_loop_resident_kernel<T, false>);
    case kResidentStamped: return reinterpret_cast<const void*>(two_loop_resident_kernel<T, true>);
    case kBlocked: return reinterpret_cast<const void*>(two_loop_blocked_kernel<T>);
    default: return nullptr;
  }
}

// The kernel of `kind` for pair_bytes 4 (f32) or 2 (bf16); group is K2's
// K in {1, 2, 4, 8} and 1 for the others.
static const void* kernel_of(int kind, int pair_bytes, int group) {
  if (pair_bytes == 4) return kernel_of_type<float>(kind, group);
  if (pair_bytes == 2) return kernel_of_type<__nv_bfloat16>(kind, group);
  return nullptr;
}

// Dynamic shared memory per element of a block's slice: q, plus all m
// pairs (resident), two groups of `group` pairs (streaming) or none
// (blocked) of (s, y).
static size_t smem_per_element(int kind, int pair_bytes, int m, int group) {
  const size_t pairs = kind == kStreaming ? 4 * (size_t)group : kind == kBlocked ? 0 : 2 * (size_t)m;
  return sizeof(float) + pairs * pair_bytes;
}

// Launch geometry of `kind` (with K2's group size `group`, 1 for the
// others) for (pair_bytes, n_pad, m) on the current device: the grid, the
// elements per block and the dynamic shared memory in bytes. Returns a
// cudaError_t; cudaErrorInvalidValue for a group no kernel has, for K1 above
// its cap, or when the slices of a one-block-per-SM grid do not fit a
// block's shared memory.
extern "C" int two_loop_config(int kind, int pair_bytes, int group, int n_pad, int m,
                               int* grid_out, int* slice_out, int* smem_out) {
  const void* kern = kernel_of(kind, pair_bytes, group);
  if (kern == nullptr || n_pad <= 0 || n_pad % kSliceAlign != 0 || m <= 0 || m > kMaxM ||
      (is_resident(kind) && m > kResidentMaxM))
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
  const size_t per = smem_per_element(kind, pair_bytes, m, group);
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

// r = H v with f32 v (n entries, 16-byte aligned), rho, out (n_pad) and
// (S, Y) of pair_bytes 4 (f32) or 2 (bf16), K2 in groups of `group` pairs,
// K3 prefetching `prefetch` rows ahead (>= 1; 0 for K1 and K2). `partials` holds 2 * kNumPartials * grid
// floats; `stamps` 2 * kStamps u64 for kResidentStamped, else null;
// `launches` a u32 the kernel adds one to per launch, or null.
// Returns the launch's cudaError_t (0 on success).
extern "C" int two_loop_launch(int kind, int pair_bytes, int group, int prefetch, const void* v,
                               const void* S, const void* Y, const void* rho, const void* head,
                               const void* count, void* out, void* partials, int n_pad, int n,
                               int m, int grid, int slice, int smem, int clamp_gamma,
                               float gamma_min, float gamma_max, void* stream, void* stamps,
                               void* launches) {
  const void* kern = kernel_of(kind, pair_bytes, group);
  if (kern == nullptr || (kind == kBlocked ? prefetch < 1 : prefetch != 0) ||
      (is_resident(kind) && m > kResidentMaxM) ||
      ((kind == kResidentStamped) != (stamps != nullptr)) || n < 0 || n > n_pad)
    return cudaErrorInvalidValue;
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
  p.n = n;
  p.m = m;
  p.slice = slice;
  p.clamp_gamma = clamp_gamma;
  p.gamma_min = gamma_min;
  p.gamma_max = gamma_max;
  p.prefetch = prefetch;
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.launches = static_cast<unsigned int*>(launches);
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(kThreads), args, (size_t)smem,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" const char* two_loop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
