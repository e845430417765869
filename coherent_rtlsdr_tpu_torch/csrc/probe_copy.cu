// Identity copy at the fused block geometry: the bandwidth ceiling of a
// kernel that reads and writes int8 blocks [T, N, m/2, 2m] the way the
// fused kernels do.
//
// Replaces tools/probe_roofline.py:_copy_kernel (the Pallas identity copy of
// probe_pallas_copy, one channel a grid step, and probe_pallas_copy_nc, nc
// channels a grid step). Plain PyTorch version:
// coherent_rtlsdr_tpu_torch/kernels/copy.py (BlockCopy.copy_plain).
//
// Design. One CTA of 256 threads per (t, group of nc channels), the grid of
// the Pallas kernel; the group is nc contiguous blocks of W = m*m bytes, and
// each thread moves 16-byte vectors, neighbouring threads on neighbouring
// addresses, with all of its loads issued before its stores. What bounds it
// on the H100: bytes only, 2 T N W (each byte read once and written once),
// 176 MB or 0.053 ms at 3.35 TB/s for T = 256, N = 21, m = 128; it does no
// arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace probe {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte vectors in flight a thread

// x, y int4 views of [T, N, W] bytes; this CTA copies the vec_per_cta
// vectors of blocks (t, g*nc .. g*nc + nc - 1), t = blockIdx.y, g =
// blockIdx.x.
__global__ void __launch_bounds__(kThreads)
copy_kernel(const int4* __restrict__ x, int4* __restrict__ y, int vec_per_cta) {
  const size_t base = (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * vec_per_cta;
  const int4* src = x + base;
  int4* dst = y + base;
  for (int i0 = threadIdx.x; i0 < vec_per_cta; i0 += kThreads * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < vec_per_cta) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < vec_per_cta) dst[i] = v[u];
    }
  }
}

}  // namespace probe

// x, y int8 [T, N, W] (W = m*m bytes a block, a multiple of 16; both
// 16-byte aligned); nc channels a CTA, N a multiple of nc. Returns the CUDA
// error code of the launch (0 on success); -1 for a shape it does not take.
extern "C" int probe_copy_blocks(const void* x, void* y, int T, int N, int W, int nc,
                                 void* stream) {
  if (T < 1 || nc < 1 || N % nc != 0 || W % 16 != 0) return -1;
  const long long vec = static_cast<long long>(nc) * (W / 16);
  if (vec > 0x7fffffff) return -1;
  probe::copy_kernel<<<dim3(N / nc, T), probe::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(y), static_cast<int>(vec));
  return cudaGetLastError();
}
