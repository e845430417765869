// Tensor-core helpers of the hand-written kernels (fourstep.cu, and every
// measure and apply kernel of fused_measure.cu / fused_apply.cu through
// fused_common.cuh): bf16 matrices in swizzled shared memory, ldmatrix
// fragment loads, the mma.sync m16n8k16 bf16 x bf16 -> f32 product, the
// twiddle, the complex products of a warp's 16-row strip, the warpgroup
// product wgmma (the m = 256 cluster kernels, fused_cluster.cuh, and the
// channel measures at m = 64 / 128, fused_measure.cu; the persistent handoff
// apply, fused_apply.cu), named barriers between the warps of a
// warp-specialised block and the split of its registers, and the
// persistent grid.
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

// The A fragment of rows r0..r0+15, k0..k0+15 of a matrix stored
// transposed, [k][row] (A[r][k] = base[k][r]), through transposed ldmatrix.
template <int COLS>
__device__ __forceinline__ void ldsm_a_trans(const __nv_bfloat16* base, int r0, int k0,
                                             uint32_t (&d)[4]) {
  const int l = threadIdx.x & 31;
  ldsm_x4_trans(smem_addr(base + swz<COLS>(k0 + (l & 7) + (l >> 4) * 8, r0 + ((l >> 3) & 1) * 8)),
                d);
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

// B * T (forward) or C * conj(T) (inverse) of one complex element against
// the float32 twiddle (tr, ti), each product rounded on its own as the plain
// version's elementwise ops round (no FMA contraction).
template <bool CONJ>
__device__ __forceinline__ float2 twiddle(float re, float im, float tr, float ti) {
  if (CONJ)
    return make_float2(__fadd_rn(__fmul_rn(re, tr), __fmul_rn(im, ti)),
                       __fsub_rn(__fmul_rn(im, tr), __fmul_rn(re, ti)));
  return make_float2(__fsub_rn(__fmul_rn(re, tr), __fmul_rn(im, ti)),
                     __fadd_rn(__fmul_rn(re, ti), __fmul_rn(im, tr)));
}

// --- The products of a warp's 16-row strip (rows r0..r0+15), a chunk of
// kChunk output columns at a time. Accumulator (jt, 2 hh + e) of a chunk cc
// is element (r0 + g + 8 hh, cc kChunk + 8 jt + 2t + e).

// Columns a product handles at once (kChunkTiles n8 tiles of accumulators):
// 32 keeps a fourstep.cu consumer thread at ~150 registers, under the 168
// that 384 threads an SM leave, where 64 spilled.
constexpr int kChunk = 32;
constexpr int kChunkTiles = kChunk / 8;

// acc = L R over the strip's rows and chunk cc, for complex bf16 matrices
// in swizzled planes of M columns: L (lre, lim) stored [row][k], read as A
// fragments; R (rre, rim) stored [k][n] (R_KN, read transposed) or [n][k].
template <int M, bool R_KN>
__device__ __forceinline__ void strip_product(const __nv_bfloat16* lre, const __nv_bfloat16* lim,
                                              int r0, const __nv_bfloat16* rre,
                                              const __nv_bfloat16* rim, int cc,
                                              float (&are)[kChunkTiles][4],
                                              float (&aim)[kChunkTiles][4]) {
#pragma unroll
  for (int i = 0; i < kChunkTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) are[i][e] = aim[i][e] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < M / 16; ++ks) {
    uint32_t fre[4], fim[4], fnim[4];
    ldsm_a<M>(lre, r0, ks * 16, fre);
    ldsm_a<M>(lim, r0, ks * 16, fim);
    negate(fim, fnim);
#pragma unroll
    for (int p = 0; p < kChunkTiles / 2; ++p) {
      const int n0 = cc * kChunk + p * 16;
      uint32_t bre[4], bim[4];
      if constexpr (R_KN) {
        ldsm_b_trans<M>(rre, n0, ks * 16, bre);
        ldsm_b_trans<M>(rim, n0, ks * 16, bim);
      } else {
        ldsm_b<M>(rre, n0, ks * 16, bre);
        ldsm_b<M>(rim, n0, ks * 16, bim);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        cmma(are[2 * p + h], aim[2 * p + h], fre, fim, fnim, bre[2 * h], bre[2 * h + 1],
             bim[2 * h], bim[2 * h + 1]);
    }
  }
}

// This thread's lane, read where the call stands: the compiler cannot hoist
// it, or the addresses made from it, out of a loop, where they would hold
// registers through the whole body.
__device__ __forceinline__ int lane_id() {
  int l;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(l));
  return l;
}

// Chunk cc of strip_product, twiddled (twiddle<CONJ> by T, float32 [M, M],
// read from L2) and rounded to bf16, into the strip's A fragments (cre, cim)
// of the next product: the tiles of chunk cc are its k steps 2cc, 2cc + 1.
// `lane` is this thread's lane (lane_id() where registers are short).
template <int M, bool CONJ>
__device__ __forceinline__ void twiddle_to_a(const float (&are)[kChunkTiles][4],
                                             const float (&aim)[kChunkTiles][4],
                                             const float2* __restrict__ Tw, int r0, int cc,
                                             uint32_t (&cre)[M / 16][4],
                                             uint32_t (&cim)[M / 16][4],
                                             int lane = static_cast<int>(threadIdx.x & 31)) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jt = 0; jt < kChunkTiles; ++jt) {
    const int c = cc * kChunk + jt * 8 + 2 * t;
    const int kt = cc * kChunkTiles + jt;  // n8 tile index across the strip
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + g + 8 * hh;
      const float4 tw = __ldg(reinterpret_cast<const float4*>(Tw + r * M + c));
      const float2 v0 = twiddle<CONJ>(are[jt][2 * hh], aim[jt][2 * hh], tw.x, tw.y);
      const float2 v1 = twiddle<CONJ>(are[jt][2 * hh + 1], aim[jt][2 * hh + 1], tw.z, tw.w);
      cre[kt / 2][(kt & 1) * 2 + hh] = pack_bf16(v0.x, v1.x);
      cim[kt / 2][(kt & 1) * 2 + hh] = pack_bf16(v0.y, v1.y);
    }
  }
}

// acc = C R over the strip and the kChunk columns from n_base (a multiple
// of 16; cc kChunk for chunk cc), with C the strip's A fragments (cre, cim;
// M / 16 k steps) and R (rre, rim) a symmetric table read as stored [n][k].
// Accumulator (jt, 2 hh + e) is element (r0 + g + 8 hh, n_base + 8 jt + 2t + e).
template <int M>
__device__ __forceinline__ void strip_product_a(const uint32_t (&cre)[M / 16][4],
                                                const uint32_t (&cim)[M / 16][4],
                                                const __nv_bfloat16* rre,
                                                const __nv_bfloat16* rim, int n_base,
                                                float (&dre)[kChunkTiles][4],
                                                float (&dim)[kChunkTiles][4]) {
#pragma unroll
  for (int i = 0; i < kChunkTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dre[i][e] = dim[i][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < M / 16; ++kk) {
    uint32_t ncim[4];
    negate(cim[kk], ncim);
#pragma unroll
    for (int p = 0; p < kChunkTiles / 2; ++p) {
      uint32_t bre[4], bim[4];
      ldsm_b<M>(rre, n_base + p * 16, kk * 16, bre);
      ldsm_b<M>(rim, n_base + p * 16, kk * 16, bim);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        cmma(dre[2 * p + h], dim[2 * p + h], cre[kk], cim[kk], ncim, bre[2 * h],
             bre[2 * h + 1], bim[2 * h], bim[2 * h + 1]);
    }
  }
}

// --- wgmma (sm_90a only). A warpgroup (four consecutive warps, the first a
// multiple of 4) multiplies a 64 x 16 bf16 A held in registers (each warp
// its 16 rows, the mma.sync A fragment above) by a 16 x N bf16 B read from
// shared memory through a descriptor, into 64 x N float32 accumulators
// (each warp its 16 rows: d[j][e] is the mma.sync C fragment of n8 tile j).
// SCALE_A = -1 negates A exactly; TRANS_B = 1 reads B stored N-major (n
// contiguous: the core matrices 8 k rows of 8 n) instead of K-major. The
// products are asynchronous: fence before the first after the registers
// were written, commit, then wait.

// The descriptor of a B operand stored K-major without swizzle: 8 x 8 core
// matrices of 128 contiguous bytes, `lbo` bytes from a core matrix to its
// neighbour along k, `sbo` bytes from one group of 8 rows (n) to the next.
__device__ __forceinline__ uint64_t desc_k(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// The descriptor `d` moved on by BYTES (a multiple of 16) of shared memory:
// its start address, the low field, as an add the compiler leaves where it
// stands, so that a product's k steps hold one descriptor an operand rather
// than all of them at once.
template <uint32_t BYTES>
__device__ __forceinline__ void desc_advance(uint64_t& d) {
  static_assert(BYTES % 16 == 0, "descriptors address 16-byte units");
  asm volatile("add.s64 %0, %0, %1;\n" : "+l"(d) : "n"(BYTES >> 4));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

template <int SCALE_A, int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, %37, 1, %39;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(SCALE_A), "r"(1), "n"(TRANS_B));
}

template <int SCALE_A, int TRANS_B>
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, %21, 1, %23;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(SCALE_A), "r"(1), "n"(TRANS_B));
}

template <int N, int SCALE_A, int TRANS_B = 0>
__device__ __forceinline__ void wgmma(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 32 || N == 64, "m64n32k16 or m64n64k16");
  if constexpr (N == 64)
    wgmma_n64<SCALE_A, TRANS_B>(d, a, b);
  else
    wgmma_n32<SCALE_A, TRANS_B>(d, a, b);
}

// The warpgroup's registers a thread (sm_90a; every thread of the
// warpgroup executes it): dec gives registers back to the CTA's pool, inc
// takes them from it (waiting until they are there), so that the warpgroups
// of a warp-specialised block can split the register file unevenly.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
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

// The persistent grid of `kernel` (`threads` a CTA, `smem` bytes of dynamic
// shared memory) for a batch of B work items: every CTA that fits on the
// card at once (a whole number of waves), at most B. The first call on a
// device sets the kernel's shared memory and asks for its occupancy into
// `capacity` (the caller's, one per kernel; 0 until asked); later calls
// reuse it. Returns the grid, or minus a CUDA error code.
constexpr int kMaxDevices = 64;

template <class Kernel>
int persistent_grid(Kernel kernel, int threads, int smem, int B, int (&capacity)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && capacity[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess) capacity[dev] = sms * per_sm;
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return B < capacity[dev] ? B : capacity[dev];
}

}  // namespace tc
