// Row gather from a page-locked host store into a device batch, for the
// out-of-core S-LBFGS (lbfgs_ffnn_torch/data/outofcore.py:
// ChunkStore.fetch_rows).
//
// Replaces no TPU kernel. The JAX package gathers a minibatch's rows on the
// host (ChunkStore.fetch_rows through io_callback,
// lbfgs_ffnn_tpu/data/outofcore.py), a host round trip inside one XLA
// program. The port's S-LBFGS draws its indices on the card, inside a
// captured CUDA graph, where copying them back to the host would be a host
// sync in every inner step. So the card reads the rows itself, through the
// store's device-mapped pointer (cudaHostGetDevicePointer of the pinned
// allocation), over the host link.
//
// gather_rows_kernel: blockIdx.y picks the operand (0: x, 1: y); the
// blocks of an operand walk its output rows, a block a row at a time, and
// the block's threads copy the row in units of T, the widest of 16, 8, 4, 2
// or 1 bytes that divides the row's bytes and both base addresses (MNIST's
// x rows: 3,136 B, 196 16-byte loads; its y rows: 40 B, five 8-byte loads).
// An index outside [0, rows) gives a row of zeros. Bytes in flight are what
// a read over the host link needs (about a microsecond of latency): at
// b = 256, 256 blocks of 128 threads put up to 512 KB of loads in flight.
//
// Bound on the card: bytes. Each output row is read once over the host
// link (PCIe Gen5 x16, 64 GB/s each way published; a 256 MB pinned copy is
// timed beside it by chip_smoke.py) and written once to device memory.
//
// gather_device_pointer(host, &dev): the device address of pinned host
// memory. gather_launch(x_src, x_dst, x_row_bytes, x_rows, y_src, y_dst,
// y_row_bytes, y_rows, idx, n_idx, stream, launches): x_dst[i] =
// x_src[idx[i]] and y_dst[i] = y_src[idx[i]] for i < n_idx (idx int64 on
// the device; y_src null gathers x alone); launches, when not null, is an
// int32 device counter the kernel adds one to. Both return a cudaError_t
// (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Operand {
  const char* src;   // device address of the store's rows
  char* dst;         // (n_idx, row_bytes) on the device
  long long row_bytes;
  long long rows;    // rows in the store
  int unit;          // bytes per load and store
};

template <typename T>
__device__ __forceinline__ void copy_row(const Operand& op, long long r, long long i) {
  const long long units = op.row_bytes / sizeof(T);
  T* dst = reinterpret_cast<T*>(op.dst + i * op.row_bytes);
  if (r < 0 || r >= op.rows) {
    for (long long u = threadIdx.x; u < units; u += kThreads) dst[u] = T{};
    return;
  }
  const T* src = reinterpret_cast<const T*>(op.src + r * op.row_bytes);
  for (long long u = threadIdx.x; u < units; u += kThreads) dst[u] = src[u];
}

__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(Operand x, Operand y, const int64_t* __restrict__ idx, long long n_idx,
                       int* launches) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && launches != nullptr)
    *launches += 1;
  const Operand op = blockIdx.y == 0 ? x : y;
  for (long long i = blockIdx.x; i < n_idx; i += gridDim.x) {
    const long long r = idx[i];
    switch (op.unit) {  // the same in every thread of the block
      case 16: copy_row<uint4>(op, r, i); break;
      case 8: copy_row<uint2>(op, r, i); break;
      case 4: copy_row<uint32_t>(op, r, i); break;
      case 2: copy_row<uint16_t>(op, r, i); break;
      default: copy_row<uint8_t>(op, r, i); break;
    }
  }
}

int unit_of(const void* src, const void* dst, long long row_bytes) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                         static_cast<uintptr_t>(row_bytes);
  for (int u = 16; u > 1; u >>= 1)
    if (bits % u == 0) return u;
  return 1;
}

}  // namespace

extern "C" int gather_device_pointer(void* host, void** dev) {
  return cudaHostGetDevicePointer(dev, host, 0);
}

extern "C" int gather_launch(const void* x_src, void* x_dst, long long x_row_bytes,
                             long long x_rows, const void* y_src, void* y_dst,
                             long long y_row_bytes, long long y_rows, const void* idx,
                             long long n_idx, void* stream, void* launches) {
  if (n_idx < 1 || x_row_bytes < 1 || (y_src != nullptr && y_row_bytes < 1))
    return cudaErrorInvalidValue;
  Operand x{static_cast<const char*>(x_src), static_cast<char*>(x_dst), x_row_bytes, x_rows,
            unit_of(x_src, x_dst, x_row_bytes)};
  Operand y{static_cast<const char*>(y_src), static_cast<char*>(y_dst), y_row_bytes, y_rows,
            y_src != nullptr ? unit_of(y_src, y_dst, y_row_bytes) : 1};
  const dim3 grid(static_cast<unsigned>(n_idx < 65535 ? n_idx : 65535), y_src != nullptr ? 2 : 1);
  gather_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, static_cast<const int64_t*>(idx), n_idx, static_cast<int*>(launches));
  return cudaGetLastError();
}

extern "C" const char* gather_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
