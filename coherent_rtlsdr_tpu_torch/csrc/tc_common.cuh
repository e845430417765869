// Tensor-core helpers of the hand-written kernels (today fourstep.cu): bf16
// matrices in swizzled shared memory, ldmatrix fragment loads, the
// mma.sync m16n8k16 bf16 x bf16 -> f32 product, and named barriers between
// the warps of a warp-specialised block.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16 x 16 (row-major):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B 16 x 8  (k x n):      b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C 16 x 8  (f32):        c0 c1 (g, 2t..2t+1)  c2 c3 (g+8, 2t..2t+1)
// so the accumulators of two neighbouring n8 tiles, rounded to bf16 pairs,
// are the A fragment of the next product's 16-wide k step:
//   a0 = (c0, c1) and a1 = (c2, c3) of tile 2kk, a2 and a3 of tile 2kk+1.
//
// Every product takes bf16 operands and accumulates in float32, as the TPU's
// bf16/f32 matmul does; a complex product is four real ones,
//   re += Ar Br + (-Ai) Bi,   im += Ar Bi + Ai Br,
// with -Ai an exact sign flip of the bf16 bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// Element offset of (row, col) in a bf16 matrix of COLS columns (COLS a
// multiple of 64) whose 16-byte chunks are XOR-swizzled by row % 8, so the
// eight rows that one ldmatrix phase reads fall in eight different banks.
template <int COLS>
__device__ __forceinline__ int swz(int row, int col) {
  static_assert(COLS % 64 == 0, "a row must span at least 8 chunks of 16 bytes");
  return row * COLS + ((((col >> 3) ^ row) & 7) | ((col >> 3) & ~7)) * 8 + (col & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&d)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&d)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

// Loads of bf16 matrices stored in swizzled shared memory (`base` its first
// element, COLS columns) into mma fragments, for the 16 x 16 block at
// (r0, k0) of an A operand stored [row][k]; or the two n8 tiles n0, n0 + 8
// of a B operand at k0, stored [n][k] (ldsm_b) or [k][n] (ldsm_b_trans):
// d[0], d[1] are b0, b1 of tile n0 and d[2], d[3] those of tile n0 + 8.
template <int COLS>
__device__ __forceinline__ void ldsm_a(const __nv_bfloat16* base, int r0, int k0,
                                       uint32_t (&d)[4]) {
  const int l = threadIdx.x & 31;
  ldsm_x4(smem_addr(base + swz<COLS>(r0 + (l & 15), k0 + (l >> 4) * 8)), d);
}

template <int COLS>
__device__ __forceinline__ void ldsm_b(const __nv_bfloat16* base, int n0, int k0,
                                       uint32_t (&d)[4]) {
  const int l = threadIdx.x & 31;
  ldsm_x4(smem_addr(base + swz<COLS>(n0 + (l & 7) + (l >> 4) * 8, k0 + ((l >> 3) & 1) * 8)), d);
}

template <int COLS>
__device__ __forceinline__ void ldsm_b_trans(const __nv_bfloat16* base, int n0, int k0,
                                             uint32_t (&d)[4]) {
  const int l = threadIdx.x & 31;
  ldsm_x4_trans(smem_addr(base + swz<COLS>(k0 + (l & 15), n0 + (l >> 4) * 8)), d);
}

// acc += a b on the tensor cores: a 16 x 16, b 16 x 8, both bf16; acc 16 x 8 f32.
__device__ __forceinline__ void mma(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The complex product of one A fragment pair (re, im; nim = -im) with one
// n8 tile of B (re b0 b1, im b0 b1) into (acc_re, acc_im).
__device__ __forceinline__ void cmma(float (&acc_re)[4], float (&acc_im)[4],
                                     const uint32_t (&are)[4], const uint32_t (&aim)[4],
                                     const uint32_t (&anim)[4], uint32_t bre0, uint32_t bre1,
                                     uint32_t bim0, uint32_t bim1) {
  mma(acc_re, are, bre0, bre1);
  mma(acc_re, anim, bim0, bim1);
  mma(acc_im, are, bim0, bim1);
  mma(acc_im, aim, bre0, bre1);
}

// Two floats rounded to the nearest bf16 (ties to even), packed low, high.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The fragment with the sign of every bf16 flipped (exact).
__device__ __forceinline__ void negate(const uint32_t (&a)[4], uint32_t (&n)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) n[i] = a[i] ^ 0x80008000u;
}

// Named barriers (id 1..15; 0 is __syncthreads): `count` threads, a multiple
// of 32, take part; sync waits, arrive does not. Shared-memory writes before
// an arrive are visible after the matching sync.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace tc
