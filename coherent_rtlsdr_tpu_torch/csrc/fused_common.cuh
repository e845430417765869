// Shared device helpers of the fused measure/apply kernels
// (fused_measure.cu, fused_apply.cu).
//
// Layouts (W = m*m, m in {64, 128}):
//   * a stream block is int8 [m/2, 2m]: row r holds samples [r*m, (r+1)*m)
//     as I0 Q0 I1 Q1 ...; the window of output slot t is blocks (t, t+1);
//   * spectra are in the permuted (k2, k1) layout of kernels/fft4step.py:
//     natural bin k = k2 + m*k1 sits at row k2, column k1;
//   * the host passes the tables as interleaved (re, im) float32 [m, m]:
//     F and conj(F)/m hold bf16-rounded values (the JAX kernels cast them to
//     bf16), the twiddle T is full float32.
//
// Every complex matrix product takes bf16-valued operands and accumulates in
// float32 on the SIMT FMA units: a product of two bf16 values is exact in
// float32, so this equals the TPU's bf16/f32 matmul up to summation order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fused {

constexpr int kThreads = 256;                    // a 16 x 16 thread grid
constexpr float kTwoPi = 6.283185307179586f;     // float32(2*pi)

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Exact (k * d) mod W / W for an integer d of either sign. W is a power of
// two that divides 2^32, so unsigned 32-bit products (which wrap modulo
// 2^32) reduce exactly, and two's-complement d & (W-1) is d mod W.
template <int W>
__device__ __forceinline__ float iramp_fraction(uint32_t k, int d) {
  constexpr uint32_t mask = W - 1;
  const uint32_t dm = static_cast<uint32_t>(d) & mask;
  return static_cast<float>((k * dm) & mask) * (1.0f / W);
}

// Signed frequency (cycles/sample) of natural bin k: k/W or (k - W)/W.
template <int W>
__device__ __forceinline__ float signed_freq(uint32_t k) {
  const int ks = k < W / 2 ? static_cast<int>(k) : static_cast<int>(k) - W;
  return static_cast<float>(ks) * (1.0f / W);
}

// Sum over the block, the same value returned to every thread. The order of
// the sum is fixed, so the result is deterministic. `red` holds
// kThreads/32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // an earlier call may still be reading red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// One complex matrix product over the block:
//   out[r, c] = sum_k left(r, k) * right(k, c),   k < K,
// where thread (ty, tx) of the 16 x 16 grid owns rows r = ty + 16 i (i < TM)
// and columns c = tx + 16 j (j < TN), and hands each finished element to
// epi(r, c, re, im). left/right return float2 (re, im) and may read shared
// or global memory; consecutive tx read consecutive columns of right.
template <int TM, int TN, int K, class Left, class Right, class Epi>
__device__ __forceinline__ void cmatmul(Left left, Right right, Epi epi) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc_re[TM][TN];
  float acc_im[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_re[i][j] = acc_im[i][j] = 0.f;

#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float2 a[TM];
    float2 b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = left(ty + 16 * i, k);
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = right(k, tx + 16 * j);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc_re[i][j] = fmaf(a[i].x, b[j].x, acc_re[i][j]);
        acc_re[i][j] = fmaf(-a[i].y, b[j].y, acc_re[i][j]);
        acc_im[i][j] = fmaf(a[i].x, b[j].y, acc_im[i][j]);
        acc_im[i][j] = fmaf(a[i].y, b[j].x, acc_im[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      epi(ty + 16 * i, tx + 16 * j, acc_re[i][j], acc_im[i][j]);
}

// A complex bf16 matrix in shared memory, rows padded by one element so the
// two rows that a warp reads at once fall in different banks.
template <int M>
struct SmemBf16Matrix {
  __nv_bfloat162* p;
  static constexpr int kStride = M + 1;
  static constexpr size_t kBytes = sizeof(__nv_bfloat162) * M * kStride;
  __device__ __forceinline__ float2 get(int r, int c) const {
    return __bfloat1622float2(p[r * kStride + c]);
  }
  __device__ __forceinline__ void set(int r, int c, float re, float im) const {
    p[r * kStride + c] = __floats2bfloat162_rn(re, im);
  }
};

}  // namespace fused
