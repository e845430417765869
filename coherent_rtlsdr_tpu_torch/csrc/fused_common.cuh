// Shared device helpers of the measure and apply kernels (fused_measure.cu,
// fused_apply.cu). fourstep.cu runs its products with tc_common.cuh alone,
// and probe_copy.cu needs none of these.
//
// Layouts (W = m*m, m in {64, 128}):
//   * a stream block is int8 [m/2, 2m]: row r holds samples [r*m, (r+1)*m)
//     as I0 Q0 I1 Q1 ...; or, on the float path, two bf16 planes (re, im)
//     [m/2, m]; the window of output slot t is blocks (t, t+1);
//   * spectra are in the permuted (k2, k1) layout of kernels/fft4step.py:
//     natural bin k = k2 + m*k1 sits at row k2, column k1;
//   * the host passes the tables as interleaved (re, im) float32 [m, m]:
//     F and conj(F)/m hold bf16-rounded values (the JAX kernels cast them to
//     bf16), the twiddle T is full float32.
//
// Every complex matrix product here takes bf16 operands and accumulates in
// float32 on the tensor cores (tc_common.cuh: mma.sync m16n8k16, a warp a
// 16-row strip, the strip designs of fourstep.cu's consumers), as the TPU's
// bf16/f32 matmul does (a product of two bf16 values is exact in float32),
// so the kernels equal it up to summation order. Every measure and apply
// kernel is one CTA a window of m / 16 warps, or a persistent grid of them:
//   * the forward transform forward_tc, after a window loader
//     (load_window_i8 for int8 blocks, load_window_planes for bf16 planes)
//     and the table loader load_table;
//   * the inverse's overlap-save centre, inverse_tc_first then
//     inverse_tc_centre, whose per-chunk epilogue writes int8 wire bytes
//     through a per-warp staging tile (WireChunk) or float32 samples
//     straight to device memory (FloatChunk).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace fused {

// Lets `kernel` be launched with `bytes` of dynamic shared memory (above
// 48 kB only after this call).
template <class Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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

// Sum over a block of NT threads, the same value returned to every thread.
// The order of the sum is fixed, so the result is deterministic. `red` holds
// NT/32 floats of shared memory.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // an earlier call may still be reading red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

// The low and high bf16 of a word, exactly, as floats.
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// --- The tensor-core forward transform. One CTA a window of kTcThreads<M>
// threads, m / 16 warps: warp w owns the 16-row strip 16w..16w+15 of both
// products.
template <int M>
constexpr int kTcThreads = 2 * M;

// F (interleaved float32 [m, m], bf16-exact values, so the conversion is
// exact) into swizzled bf16 re / im planes at `tab` (2 m^2 elements), by the
// NT threads of the CTA.
template <int M, int NT = kTcThreads<M>>
__device__ __forceinline__ void load_table(const float2* __restrict__ F, __nv_bfloat16* tab) {
  constexpr int kChunks = M * M / 8;  // 8 elements, 16 bytes of a plane
  for (int q = threadIdx.x; q < kChunks; q += NT) {
    const int r = q / (M / 8);
    const int c = (q % (M / 8)) * 8;
    const float4* src = reinterpret_cast<const float4*>(F + r * M + c);
    uint32_t re[4], im[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = __ldg(src + i);  // elements c + 2i, c + 2i + 1
      re[i] = tc::pack_bf16(v.x, v.z);
      im[i] = tc::pack_bf16(v.y, v.w);
    }
    const int o = tc::swz<M>(r, c);
    *reinterpret_cast<uint4*>(tab + o) = make_uint4(re[0], re[1], re[2], re[3]);
    *reinterpret_cast<uint4*>(tab + M * M + o) = make_uint4(im[0], im[1], im[2], im[3]);
  }
}

// Signed byte k (0..3, little-endian) of a 32-bit word, as a float.
__device__ __forceinline__ float sbyte(int x, int k) {
  return static_cast<float>(static_cast<signed char>(x >> (8 * k)));
}

// The window of the i8 path into swizzled bf16 re / im planes at `win` (2 m^2
// elements): rows 0..m/2-1 from the int8 block `top`, rows m/2..m-1 from
// `top + next`; A = bf16(float(i8) * (1/127)), as the plain version rounds.
// 16 bytes (8 samples) a load, all of a thread's loads in flight at once.
template <int M>
__device__ __forceinline__ void load_window_i8(const int8_t* __restrict__ top, size_t next,
                                               __nv_bfloat16* win) {
  constexpr float kScale = static_cast<float>(1.0 / 127.0);
  constexpr int kThreads = kTcThreads<M>;
  constexpr int kVec = M * M / 16;  // vectors a half-window (m*m contiguous bytes)
  constexpr int kSteps = 2 * kVec / kThreads;
  static_assert(2 * kVec % kThreads == 0, "whole rounds only");
  int4 v[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int w = threadIdx.x + u * kThreads;
    const int half = w / kVec;
    v[u] = __ldg(reinterpret_cast<const int4*>(top + half * next) + (w - half * kVec));
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    // Vector w holds samples 8w..8w+7 of the window: row 8w / m, columns
    // from (8w) % m, one 16-byte chunk of each plane.
    // Word j holds I Q I Q of samples 2j, 2j + 1.
    const int s = 8 * (threadIdx.x + u * kThreads);
    const int words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
    uint32_t re[4], im[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = words[j];
      re[j] = tc::pack_bf16(sbyte(x, 0) * kScale, sbyte(x, 2) * kScale);
      im[j] = tc::pack_bf16(sbyte(x, 1) * kScale, sbyte(x, 3) * kScale);
    }
    const int o = tc::swz<M>(s / M, s % M);
    *reinterpret_cast<uint4*>(win + o) = make_uint4(re[0], re[1], re[2], re[3]);
    *reinterpret_cast<uint4*>(win + M * M + o) = make_uint4(im[0], im[1], im[2], im[3]);
  }
}

// The window of the float path into swizzled bf16 re / im planes at `win`:
// rows 0..m/2-1 from the block planes `re`, `im` (bf16 [m/2, m]), rows
// m/2..m-1 from `re + next`, `im + next`, the same channel's next block.
// The planes are bf16 already, so each 16-byte vector (8 elements) is
// stored as it is loaded; all of a thread's loads in flight at once.
template <int M>
__device__ __forceinline__ void load_window_planes(const __nv_bfloat16* __restrict__ re,
                                                   const __nv_bfloat16* __restrict__ im,
                                                   size_t next, __nv_bfloat16* win) {
  constexpr int kThreads = kTcThreads<M>;
  constexpr int kVec = M * M / 16;  // vectors of a half-window plane (m*m/2 elements)
  constexpr int kSteps = 2 * kVec / kThreads;
  static_assert(2 * kVec % kThreads == 0, "whole rounds only");
  uint4 vr[kSteps], vi[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int w = threadIdx.x + u * kThreads;
    const int half = w / kVec;
    vr[u] = __ldg(reinterpret_cast<const uint4*>(re + half * next) + (w - half * kVec));
    vi[u] = __ldg(reinterpret_cast<const uint4*>(im + half * next) + (w - half * kVec));
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    // Vector w holds elements 8w..8w+7 of the window: row 8w / m, columns
    // from (8w) % m, one 16-byte chunk of each plane.
    const int e = 8 * (threadIdx.x + u * kThreads);
    const int o = tc::swz<M>(e / M, e % M);
    *reinterpret_cast<uint4*>(win + o) = vr[u];
    *reinterpret_cast<uint4*>(win + M * M + o) = vi[u];
  }
}

// Forward four-step of the window at `win` (swizzled bf16 re / im planes of
// A[n2][n1]) with the table at `tab` (F re / im planes), on the tensor cores;
// every thread of the CTA calls it after a barrier behind the loads. Warp w:
//   B = F A on its rows r of F (ldmatrix A fragments) and every row of the
//   window (transposed ldmatrix B fragments); C = bf16(B * T) in registers,
//   the twiddle T (float32) read from L2; then a CTA barrier, after which
//   the window's buffer may be overwritten; then D = C F with C as the A
//   fragments. Each finished pair of D elements (r, c), (r, c + 1), c even,
//   is handed to epi(r, c, float4(re_c, im_c, re_c+1, im_c+1)).
template <int M, class Epi>
__device__ __forceinline__ void forward_tc(const __nv_bfloat16* tab, const __nv_bfloat16* win,
                                           const float2* __restrict__ Tw, Epi epi) {
  constexpr int NT = tc::kChunkTiles;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  uint32_t cre[M / 16][4], cim[M / 16][4];
#pragma unroll
  for (int cc = 0; cc < M / tc::kChunk; ++cc) {
    float are[NT][4], aim[NT][4];
    tc::strip_product<M, true>(tab, tab + M * M, r0, win, win + M * M, cc, are, aim);
    tc::twiddle_to_a<M, false>(are, aim, Tw, r0, cc, cre, cim);
  }
  // Every warp has read the whole window.
  __syncthreads();
#pragma unroll 1
  for (int cc = 0; cc < M / tc::kChunk; ++cc) {
    float dre[NT][4], dim[NT][4];
    tc::strip_product_a<M>(cre, cim, tab, tab + M * M, cc * tc::kChunk, dre, dim);
#pragma unroll
    for (int jt = 0; jt < NT; ++jt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        epi(r0 + g + 8 * hh, cc * tc::kChunk + jt * 8 + 2 * t,
            make_float4(dre[jt][2 * hh], dim[jt][2 * hh], dre[jt][2 * hh + 1],
                        dim[jt][2 * hh + 1]));
  }
}

// --- The tensor-core inverse of the apply kernels: the overlap-save centre
// rows of the inverse four-step of a permuted spectrum G. It runs
// transposed, as fourstep.cu's inverse consumer does (F, Fi and T are
// symmetric): C2^T = Fi G^T, B2^T = bf16(C2^T * conj(T)), y^T = B2^T Fi, so
// that B2 stays in registers. Warp w owns the strip of rows n1 =
// 16w..16w+15 of both products; in the second, only the columns n2 in
// [m/4, 3m/4) that the output keeps are computed. Output row n2 - m/4 of a
// window holds the samples (re, im) of columns n1.

// First product and twiddle on G (swizzled bf16 re / im planes at `g`,
// stored [k2][k1]) with the Fi table (planes at `tab`): the strip's rows of
// B2^T as the A fragments (cre, cim) of the second product.
template <int M>
__device__ __forceinline__ void inverse_tc_first(const __nv_bfloat16* tab,
                                                 const __nv_bfloat16* g,
                                                 const float2* __restrict__ Tw, int r0,
                                                 uint32_t (&cre)[M / 16][4],
                                                 uint32_t (&cim)[M / 16][4]) {
#pragma unroll
  for (int cc = 0; cc < M / tc::kChunk; ++cc) {
    float are[tc::kChunkTiles][4], aim[tc::kChunkTiles][4];
    tc::strip_product<M, false>(tab, tab + M * M, r0, g, g + M * M, cc, are, aim);
    tc::twiddle_to_a<M, true>(are, aim, Tw, r0, cc, cre, cim);
  }
}

// Second product on the centre columns of the strip (A fragments from
// inverse_tc_first, the Fi table at `tab`), a chunk of kChunk columns n2 at
// a time: epi(n0, yre, yim) gets the chunk from column n0, accumulator
// (jt, 2 hh + e) of lane (g, t) being (n1 = r0 + g + 8 hh, n2 = n0 + 8 jt +
// 2t + e).
template <int M, class Epi>
__device__ __forceinline__ void inverse_tc_centre(const uint32_t (&cre)[M / 16][4],
                                                  const uint32_t (&cim)[M / 16][4],
                                                  const __nv_bfloat16* tab, Epi& epi) {
  static_assert((M / 2) % tc::kChunk == 0, "whole chunks of centre columns");
#pragma unroll 1
  for (int n0 = M / 4; n0 < 3 * M / 4; n0 += tc::kChunk) {
    float yre[tc::kChunkTiles][4], yim[tc::kChunkTiles][4];
    tc::strip_product_a<M>(cre, cim, tab, tab + M * M, n0, yre, yim);
    epi(n0, yre, yim);
  }
}

// Bytes of a warp's staging tile: a chunk's kChunk output rows n2 of 32
// bytes, the (re, im) int8 pairs of the strip's 16 columns n1.
constexpr int kWireStage = tc::kChunk * 32;

// (re, im) rounded half to even x127 and saturated, as the int8 wire pair
// (re in the low byte).
__device__ __forceinline__ uint16_t wire_pair(float re, float im) {
  const int qre = static_cast<int>(fminf(fmaxf(rintf(re * 127.0f), -128.f), 127.f));
  const int qim = static_cast<int>(fminf(fmaxf(rintf(im * 127.0f), -128.f), 127.f));
  return static_cast<uint16_t>((qre & 0xff) | ((qim & 0xff) << 8));
}

// Byte offset of (row, byte col) in a staging tile of 32-byte rows, the two
// 16-byte halves swapped on rows 4..7 mod 8: the warp's 2-byte writes and
// its 16-byte reads each meet 32 different banks.
__device__ __forceinline__ int stage_offset(int row, int col) {
  return row * 32 + (col ^ (((row >> 2) & 1) << 4));
}

// The i8 applies' epilogue of inverse_tc_centre: the strip's chunk
// quantized into the window's wire block out [m/2, 2m], where row n2 - m/4
// holds (re, im) of column n1 at bytes 2 n1, 2 n1 + 1, so the strip is 32
// contiguous bytes of each row. The chunk goes through the warp's staging
// tile `st` (kWireStage bytes) and out as 16-byte stores, two lanes a row.
template <int M>
struct WireChunk {
  unsigned char* st;
  int r0;
  int8_t* out;

  __device__ __forceinline__ void operator()(int n0, const float (&yre)[tc::kChunkTiles][4],
                                             const float (&yim)[tc::kChunkTiles][4]) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // Accumulator (jt, 2 hh + e): staged row n2 - n0, bytes 2 (g + 8 hh).
#pragma unroll
    for (int jt = 0; jt < tc::kChunkTiles; ++jt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<uint16_t*>(st + stage_offset(8 * jt + 2 * t + e, 2 * (g + 8 * hh))) =
              wire_pair(yre[jt][2 * hh + e], yim[jt][2 * hh + e]);
    __syncwarp();
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int row = pass * 16 + (lane >> 1);
      const int half = lane & 1;
      const int4 v = *reinterpret_cast<const int4*>(st + stage_offset(row, 16 * half));
      __stcs(reinterpret_cast<int4*>(out + (n0 - M / 4 + row) * (2 * M) + 2 * r0 + 16 * half), v);
    }
    __syncwarp();
  }
};

// The float apply's epilogue of inverse_tc_centre: the strip's chunk as
// float32 samples y[(n2 - m/4) m + n1] of the window's planes yre, yim
// [m/2, m]. One store instruction writes 4 rows n2 x 8 consecutive n1 of a
// plane, four whole 32-byte sectors, so the streaming stores go straight
// out with no staging tile.
template <int M>
struct FloatChunk {
  int r0;
  float* yre;
  float* yim;

  __device__ __forceinline__ void operator()(int n0, const float (&are)[tc::kChunkTiles][4],
                                             const float (&aim)[tc::kChunkTiles][4]) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int jt = 0; jt < tc::kChunkTiles; ++jt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = (n0 - M / 4 + 8 * jt + 2 * t + e) * M + r0 + g + 8 * hh;
          __stcs(yre + o, are[jt][2 * hh + e]);
          __stcs(yim + o, aim[jt][2 * hh + e]);
        }
  }
};

}  // namespace fused
