// Four-step FFT kernel on the tensor cores: forward or inverse W = m*m point
// transforms of a batch, in the permuted (k2, k1) frequency layout of
// kernels/fft4step.py.
//
// Replaces coherent_rtlsdr_tpu/kernels/pallas_fft.py:_fourstep_kernel,
// _fourstep_kernel_inv and _fourstep_kernel_tiled (FFT4StepPallas.fft /
// .ifft through _run_fourstep). Plain PyTorch version:
// coherent_rtlsdr_tpu_torch/kernels/fft4step.py:FFT4Step at bf16 (wrapped by
// kernels/fourstep.py:FFT4StepKernel.fft_plain / ifft_plain).
//
//   forward:  A = bf16(x);  B = F A;  C = bf16(B * T);  D = C F
//   inverse:  G = bf16(X);  C = G Fi;  B = bf16(C * conj(T));  x = Fi B
//
// with F and Fi = conj(F)/m bf16-rounded and T float32: every product takes
// bf16 operands and accumulates in float32, as the Pallas bodies cast.
//
// What bounds it on the H100: the bytes the function must move, 128 kB in
// and 128 kB out a transform at m = 128 (78 ns at 3.35 TB/s), against 34 ns
// for its 33.6 MFLOP at the bf16 tensor-core peak; so the products must
// overlap the memory traffic, at >= 430 TFLOP/s. The earlier body ran the
// products on the SIMT FMA units, one CTA a transform in serial phases.
//
// Design.
//   * Products on the tensor cores: mma.sync m16n8k16 bf16 -> f32, each
//     complex product as four real ones (tc_common.cuh).
//   * One warp owns a strip of 16 rows of the transform: the first product
//     leaves the strip's rows in its accumulators, the twiddle and the bf16
//     rounding run on them in registers, and they are the A fragments of the
//     second product, so the intermediate never goes to shared memory. The
//     inverse runs transposed (C^T = Fi G^T, x^T = B^T Fi; F, Fi and T are
//     symmetric) so that it too keeps its intermediate in registers; its
//     output is turned back through a small per-warp staging tile.
//   * Tables once a CTA: F or Fi as bf16 re / im planes in swizzled shared
//     memory (64 kB at m = 128), read by ldmatrix; the twiddle stays float32
//     and is read from L2 in the first product's epilogue.
//   * A persistent grid (one CTA an SM at m = 128) walks the batch. Four
//     producer warps stream the next window from device memory, round it to
//     bf16 and write it into the other of two window buffers while the
//     m / 16 consumer warps compute; named barriers hand the buffers over.
//   * Stores: 16-byte, four neighbouring threads on 64 contiguous bytes
//     (forward) or eight on 128 (inverse, after the staging tile).
// Shared memory at m = 128: 64 kB tables + 2 x 64 kB windows + 9 kB staging.

#include "tc_common.cuh"

namespace fourstep {

constexpr int kProducerWarps = 4;
constexpr int kLoadUnroll = 8;  // 16-byte loads in flight a producer thread
constexpr int kStageStride = 36;  // floats a staged row: 16 complex + 4 padding
constexpr int kFull = 1;          // named barriers kFull + s: window s is loaded
constexpr int kEmpty = 3;         // kEmpty + s: window s may be overwritten

template <int M>
struct Plan {
  static constexpr int kConsumerWarps = M / 16;  // a strip of 16 rows each
  static constexpr int kConsumers = 32 * kConsumerWarps;
  static constexpr int kProducers = 32 * kProducerWarps;
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kPlane = M * M;  // bf16 elements of one plane
  // Tables (re, im), two windows (re, im), a staging tile a consumer warp.
  static constexpr size_t kBytes = 6 * kPlane * sizeof(__nv_bfloat16) +
                                   kConsumerWarps * 8 * kStageStride * sizeof(float);
};

// Producer warps: window j of this CTA (transform blockIdx.x + j gridDim.x)
// into buffer j % 2 as swizzled bf16 planes [row][col] of the [m, m] input.
template <int M>
__device__ __forceinline__ void produce(const float2* __restrict__ x, __nv_bfloat16* win,
                                        int n_local) {
  using P = Plan<M>;
  constexpr int kVec = M * M / 2;  // float4 (two complex samples) a window
  static_assert(kVec % (P::kProducers * kLoadUnroll) == 0, "whole rounds only");
  const int p = threadIdx.x - P::kConsumers;
  for (int j = 0; j < n_local; ++j) {
    const int s = j & 1;
    if (j >= 2) tc::bar_sync(kEmpty + s, P::kThreads);
    const size_t b = blockIdx.x + static_cast<size_t>(j) * gridDim.x;
    const float4* src = reinterpret_cast<const float4*>(x + b * M * M);
    __nv_bfloat16* re = win + s * 2 * P::kPlane;
    __nv_bfloat16* im = re + P::kPlane;
    for (int q0 = p; q0 < kVec; q0 += P::kProducers * kLoadUnroll) {
      float4 v[kLoadUnroll];
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u) v[u] = __ldcs(src + q0 + u * P::kProducers);
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u) {
        const int e = 2 * (q0 + u * P::kProducers);
        const int o = tc::swz<M>(e / M, e % M);
        *reinterpret_cast<uint32_t*>(re + o) = tc::pack_bf16(v[u].x, v[u].z);
        *reinterpret_cast<uint32_t*>(im + o) = tc::pack_bf16(v[u].y, v[u].w);
      }
    }
    tc::bar_arrive(kFull + s, P::kThreads);
  }
}

// Consumer warp: rows r0..r0+15 of both products of every window of this
// CTA. First product: acc[r, c] = sum_k tab[r, k] R[k, c] with R the window
// (forward: A[n2, n1] stored [k][n]; inverse: G^T, i.e. G stored [n][k]);
// twiddle; second product: out[r, c'] = sum_c C[r, c] tab[c, c'], the
// symmetric table read as stored [n][k].
template <int M, bool INVERSE>
__device__ __forceinline__ void consume(const __nv_bfloat16* tab, const __nv_bfloat16* win,
                                        float* stage, const float2* __restrict__ Tw,
                                        float2* __restrict__ y, int n_local) {
  using P = Plan<M>;
  using tc::kChunk;
  constexpr int KS = M / 16;       // k steps of 16
  constexpr int NCH = M / kChunk;  // column chunks
  constexpr int NT = tc::kChunkTiles;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * 16;
  const __nv_bfloat16* tre = tab;
  const __nv_bfloat16* tim = tab + P::kPlane;
  float* st = stage + warp * 8 * kStageStride;

  for (int j = 0; j < n_local; ++j) {
    const int s = j & 1;
    const size_t b = blockIdx.x + static_cast<size_t>(j) * gridDim.x;
    const __nv_bfloat16* wre = win + s * 2 * P::kPlane;
    const __nv_bfloat16* wim = wre + P::kPlane;
    float2* yb = y + b * M * M;
    tc::bar_sync(kFull + s, P::kThreads);

    // First product, a chunk of kChunk columns at a time; its twiddled bf16
    // result becomes the A fragments cre / cim of the second.
    uint32_t cre[KS][4], cim[KS][4];
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      float are[NT][4], aim[NT][4];
      tc::strip_product<M, !INVERSE>(tre, tim, r0, wre, wim, cc, are, aim);
      tc::twiddle_to_a<M, INVERSE>(are, aim, Tw, r0, cc, cre, cim);
    }
    // The window is consumed: the producers may refill its buffer.
    if (j + 2 < n_local) tc::bar_arrive(kEmpty + s, P::kThreads);

    // Second product and the stores, a chunk of kChunk output columns at a time.
#pragma unroll 1
    for (int cc = 0; cc < NCH; ++cc) {
      float dre[NT][4], dim[NT][4];
      tc::strip_product_a<M>(cre, cim, tre, tim, cc * kChunk, dre, dim);
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        const int c = cc * kChunk + jt * 8 + 2 * t;
        if constexpr (INVERSE) {
          // out^T: this strip's rows are n1, its columns n2; y[n2, n1].
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<float2*>(st + (2 * t + e) * kStageStride + (g + 8 * hh) * 2) =
                  make_float2(dre[jt][2 * hh + e], dim[jt][2 * hh + e]);
          __syncwarp();
#pragma unroll
          for (int pass = 0; pass < 2; ++pass) {
            const int row = pass * 4 + (lane >> 3);
            const int q = lane & 7;
            const float4 v = *reinterpret_cast<const float4*>(st + row * kStageStride + q * 4);
            __stcs(reinterpret_cast<float4*>(yb + (cc * kChunk + jt * 8 + row) * M + r0 + 2 * q), v);
          }
          __syncwarp();
        } else {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            __stcs(reinterpret_cast<float4*>(yb + (r0 + g + 8 * hh) * M + c),
                   make_float4(dre[jt][2 * hh], dim[jt][2 * hh], dre[jt][2 * hh + 1],
                               dim[jt][2 * hh + 1]));
        }
      }
    }
  }
}

// x, y complex64 [B, m, m]; tab the packed bf16 table [2 (re, im), m, m] of
// F (forward) or Fi (inverse); Tw the twiddle, float2 [m, m]. CTA b handles
// transforms b, b + gridDim.x, ...
template <int M, bool INVERSE>
__global__ void __launch_bounds__(Plan<M>::kThreads, 1)
fourstep_kernel(const float2* __restrict__ x, const __nv_bfloat16* __restrict__ tab,
                const float2* __restrict__ Tw, float2* __restrict__ y, int B) {
  using P = Plan<M>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tab_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* win_s = tab_s + 2 * P::kPlane;
  float* stage_s = reinterpret_cast<float*>(win_s + 4 * P::kPlane);

  // The table, 16-byte chunks into swizzled rows (row = plane * M + r).
  constexpr int kChunks = 2 * P::kPlane / 8;
  for (int q = threadIdx.x; q < kChunks; q += P::kThreads) {
    const int row = q / (M / 8);
    *reinterpret_cast<int4*>(tab_s + tc::swz<M>(row, (q % (M / 8)) * 8)) =
        __ldg(reinterpret_cast<const int4*>(tab) + q);
  }
  __syncthreads();

  const int grid = static_cast<int>(gridDim.x);
  const int n_local = (B - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  if (threadIdx.x >= P::kConsumers)
    produce<M>(x, win_s, n_local);
  else
    consume<M, INVERSE>(tab_s, win_s, stage_s, Tw, y, n_local);
}

template <int M, bool INVERSE>
int launch(const void* x, const void* tab, const void* Tw, void* y, int B, void* stream) {
  static int capacity[tc::kMaxDevices];  // the persistent grid's occupancy, a device
  const int grid = tc::persistent_grid(fourstep_kernel<M, INVERSE>, Plan<M>::kThreads,
                                       static_cast<int>(Plan<M>::kBytes), B, capacity);
  if (grid < 0) return -grid;
  fourstep_kernel<M, INVERSE>
      <<<grid, Plan<M>::kThreads, Plan<M>::kBytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float2*>(x), static_cast<const __nv_bfloat16*>(tab),
          static_cast<const float2*>(Tw), static_cast<float2*>(y), B);
  return cudaGetLastError();
}

}  // namespace fourstep

// x, y complex64 [B, m, m] (B >= 1); tab the bf16 [2, m, m] (re, im) planes
// of F (inverse = 0) or Fi = conj(F)/m (inverse = 1), bf16-rounded; Tw the
// twiddle, float2 [m, m]; all 16-byte aligned. Returns the CUDA error code of
// the launch (0 on success); -1 for an unsupported m or B < 1.
extern "C" int fourstep_fft(const void* x, const void* tab, const void* Tw, void* y, int B,
                            int m, int inverse, void* stream) {
  if (B < 1) return -1;
  switch (m * 2 + (inverse ? 1 : 0)) {
    case 64 * 2:
      return fourstep::launch<64, false>(x, tab, Tw, y, B, stream);
    case 64 * 2 + 1:
      return fourstep::launch<64, true>(x, tab, Tw, y, B, stream);
    case 128 * 2:
      return fourstep::launch<128, false>(x, tab, Tw, y, B, stream);
    case 128 * 2 + 1:
      return fourstep::launch<128, true>(x, tab, Tw, y, B, stream);
    default:
      return -1;
  }
}
