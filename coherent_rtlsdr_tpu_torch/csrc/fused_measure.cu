// Fused measure kernels: forward four-step FFT of each overlap-save window,
// cross-spectrum with the reference window, and the two-stage phase-zoom
// lag estimator.
//
// Replaces, in coherent_rtlsdr_tpu/kernels/pallas_fused.py:
//   * _measure_kernel_i8_spec (FusedPipelineKernels.measure_i8_spec): int8
//     blocks in, five scalars and the stored bf16 window spectrum out, as two
//     kernels, fused_measure_ref then fused_measure_i8_spec;
//   * _measure_kernel_i8 (FusedPipelineKernels.measure_i8): the same five
//     scalars with no spectrum stored, as fused_measure_ref then
//     fused_measure_i8 (the channel kernel with STORE_D = false);
//   * _measure_kernel (FusedPipelineKernels.measure): bf16 block planes and
//     bf16 reference spectra in, four scalars out, no spectrum stored
//     (fused_measure_planes).
// Plain PyTorch versions: coherent_rtlsdr_tpu_torch/kernels/fused.py
// (measure_ref_plain, measure_spec_plain, measure_i8_plain, measure_plain).
//
// Design. One CTA a window: (t) for the reference, (n, t) for the channels.
// On the TPU one grid step carried the reference spectrum R across its
// channels; CUDA blocks share nothing, so on the i8 path a first kernel,
// the same transform in reference mode (fused_measure_ref), writes R
// (float32) and its energy per window, and the channel kernel reads them
// from L2; the float path gets R from the host as bf16 planes. What bounds
// them on the H100: the four real m^3 products of each of the two complex
// products (33.6 MFLOP a window at m = 128, 0.18 ms over 5,355 windows at
// the bf16 tensor-core peak) against the window in (32 kB of int8, or 64 kB
// of bf16 planes), R read (128 kB of float32, or 64 kB of bf16 planes, from
// L2, shared by the N channels of a slot) and, for fused_measure_i8_spec,
// 64 kB of D out a window. The products run on the tensor cores (forward_tc
// in fused_common.cuh: mma.sync m16n8k16 bf16 -> f32, a warp a 16-row
// strip, the first product's twiddled bf16 result kept in registers as the
// second's A fragments), m / 16 warps a CTA. One body, measure_window,
// serves every channel kernel, over a window loader (load_window_i8 or
// load_window_planes), an R reader (float32 pairs or bf16 planes) and an
// output writer (the i8 five scalars, with D stored or not, or the float
// four). The epilogue works on the accumulators: D stored as bf16
// (STORE_D), G = D conj(R) into shared float32, or R and its energy
// (reference mode). The phase zoom and the scalars then run on the SIMT
// units. Shared memory, 196,640 bytes at m = 128:
//   table (2 m^2 bf16):  F as swizzled re / im planes; after the second
//                        product, the phase zoom's aux scratch
//   window (m^2 float2): the window as swizzled bf16 re / im planes, then
//                        (after forward_tc's barrier) G
// The load has no overlap with the products, and the grid is one CTA a
// window: a persistent grid with a double-buffered producer (fourstep.cu,
// fused_apply.cu), TMA or wgmma is later work.
//
// m = 256 (W = 65536): no CTA can hold a window (the layout above needs
// 786 kB of shared memory, and a 16-row strip at full width 256 float32
// accumulators a thread), so measure_ref_cluster_kernel,
// measure_cluster_kernel<STORE_D> (fused_measure_i8_spec with the D store,
// fused_measure_i8 without) and measure_planes_cluster_kernel run a window
// on a cluster of four CTAs of four warpgroups (fused_cluster.cuh:
// forward_cluster over a strip loader, StripI8 or StripPlanes; F streamed
// once a cluster through the table ring, the products on wgmma), and the
// phase zoom (cluster_phase_zoom) sums across the cluster in rank order.
// One body, measure_cluster_window, serves both channel kernels, as
// measure_window does below m = 256. The second product's D is staged as
// float32 over G's place, then one pass of 16-byte pairs stores D (bf16),
// forms G = D conj(R) in place and sums the energies: the staging keeps
// the epilogue's R loads and registers apart from the accumulators (128
// registers a thread, no spill). Shared memory a CTA, 196,784 bytes: X
// (64 kB: the window's strip, then C's row block, then the zoom's
// scratch), Y (64 kB: C's strip, which the other CTAs gather), Z (64 kB:
// the ring's four slots while the products run), the block_sum scratch,
// the partial sums and the ring's barriers; G [64][256] float32 overlays Y
// and Z once the products are done. What bounds them: see fused_cluster.cuh;
// the SIMT phase zoom and the epilogue's pass add ~0.6 ms to a forward
// transform's ~1.3 at 1,323 windows.

#include "fused_cluster.cuh"
#include "fused_common.cuh"

namespace fused {

// Shared memory of every measure kernel (kTcThreads<M> threads).
template <int M>
struct TcMeasureSmem {
  static constexpr size_t kTable = 2 * sizeof(__nv_bfloat16) * M * M;
  static constexpr size_t kWindow = sizeof(float2) * M * M;
  static constexpr size_t kBytes = kTable + kWindow + sizeof(float) * (kTcThreads<M> / 32);
  static_assert(sizeof(float2) * M * M / 8 <= kTable, "phase_zoom's aux fits in the table");
};

struct ZoomResult {
  float lag, zre, zim;  // the same values in every thread
};

// The two-stage banded phase-slope estimator (_phase_zoom_core) on the
// permuted cross-spectrum G (float2 [m*m], shared), which it deramps in
// place, run by a block of NT threads (NT a multiple of m). aux is free
// shared scratch of m*m/8 float2, red the block_sum scratch.
template <int M, int NT>
__device__ __forceinline__ ZoomResult phase_zoom(float2* G, float2* aux, float* red) {
  static_assert(NT % M == 0 && NT % 32 == 0, "whole columns and warps");
  constexpr int W = M * M;
  // --- stage 1: 8-bin bands are row groups of 8 within a column (band
  // b = k1*(m/8) + j); g1[j][k1] in aux.
  float2* g1 = aux;
  for (int i = threadIdx.x; i < (M / 8) * M; i += NT) {
    const int j = i / M;
    const int c = i % M;
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 g = G[(8 * j + q) * M + c];
      sr += g.x;
      si += g.y;
    }
    g1[i] = make_float2(sr, si);
  }
  __syncthreads();
  // Adjacent-band products g1[b+1] conj(g1[b]): within a column for j >= 1;
  // across the column boundary (m/8-1, k1-1) -> (0, k1) for j = 0, except at
  // the Nyquist straddle k1 - 1 = m/2 - 1.
  float s1re = 0.f, s1im = 0.f;
  for (int i = threadIdx.x; i < (M / 8) * M; i += NT) {
    const int j = i / M;
    const int c = i % M;
    float2 prev;
    if (j > 0) {
      prev = g1[i - M];
    } else if (c >= 1 && c - 1 != M / 2 - 1) {
      prev = g1[(M / 8 - 1) * M + c - 1];
    } else {
      continue;
    }
    const float2 cur = g1[i];
    s1re += cur.x * prev.x + cur.y * prev.y;
    s1im += cur.y * prev.x - cur.x * prev.y;
  }
  s1re = block_sum<NT>(s1re, red);
  s1im = block_sum<NT>(s1im, red);
  constexpr float kStage1 = static_cast<float>((W / 8) / 6.283185307179586);
  const float int_lag = rintf(-atan2f(s1im, s1re) * kStage1);

  // --- stage 2: deramp G by the integer lag, in place.
  const int neg_lag = -static_cast<int>(int_lag);
  for (int i = threadIdx.x; i < M * M; i += NT) {
    const int r = i / M;
    const int c = i % M;
    // sin / cos of 2 pi f, f in [0, 1), in units of pi: the exact argument
    // reduction of sincospif needs no stack, where sincosf's general one
    // keeps a local array.
    float s, co;
    sincospif(2.f * iramp_fraction<W>(static_cast<uint32_t>(r + M * c), neg_lag), &s, &co);
    const float2 g = G[i];
    G[i] = make_float2(g.x * co + g.y * s, g.y * co - g.x * s);  // G * (cos - i sin)
  }
  __syncthreads();
  // 2m-bin bands are column pairs: column sums (kP partial sums a column,
  // combined in a fixed order), then pair sums g2[b] = col[2b] + col[2b+1].
  constexpr int kP = NT / M;
  float2* part = aux;            // [kP][M]
  float2* g2 = aux + kP * M;     // [M/2]
  {
    const int c = threadIdx.x % M;
    const int p = threadIdx.x / M;
    float sr = 0.f, si = 0.f;
    for (int r = p; r < M; r += kP) {
      const float2 g = G[r * M + c];
      sr += g.x;
      si += g.y;
    }
    part[p * M + c] = make_float2(sr, si);
  }
  __syncthreads();
  if (threadIdx.x < M / 2) {
    float sr = 0.f, si = 0.f;
    for (int p = 0; p < kP; ++p) {
      const float2 a = part[p * M + 2 * threadIdx.x];
      const float2 b = part[p * M + 2 * threadIdx.x + 1];
      sr += a.x + b.x;
      si += a.y + b.y;
    }
    g2[threadIdx.x] = make_float2(sr, si);
  }
  __syncthreads();
  // Adjacent pair-band products, the Nyquist pair M2/2 - 1 masked; every
  // thread sums the M2 - 1 terms itself in the same order.
  constexpr int M2 = M / 2;
  float s2re = 0.f, s2im = 0.f;
  for (int b = 1; b < M2; ++b) {
    if (b - 1 == M2 / 2 - 1) continue;
    const float2 cur = g2[b];
    const float2 prev = g2[b - 1];
    s2re += cur.x * prev.x + cur.y * prev.y;
    s2im += cur.y * prev.x - cur.x * prev.y;
  }
  constexpr float kStage2 = static_cast<float>(M2 / 6.283185307179586);
  const float frac = fminf(fmaxf(-atan2f(s2im, s2re) * kStage2, -4.f), 4.f);

  // --- correlation value at the fractional lag: z = sum Gc e^{2 pi i frac f}.
  const float w = 2.f * frac;  // in units of pi
  float zre = 0.f, zim = 0.f;
  for (int i = threadIdx.x; i < M * M; i += NT) {
    const int r = i / M;
    const int c = i % M;
    float s, co;
    sincospif(w * signed_freq<W>(static_cast<uint32_t>(r + M * c)), &s, &co);
    const float2 g = G[i];
    zre += g.x * co - g.y * s;
    zim += g.x * s + g.y * co;
  }
  zre = block_sum<NT>(zre, red);
  zim = block_sum<NT>(zim, red);
  return ZoomResult{int_lag + frac, zre, zim};
}

// Reference mode: one CTA per window t writes R[t] (float2 [m, m]) and
// eref[t] = sum |R|^2.
template <int M>
__global__ void __launch_bounds__(kTcThreads<M>)
measure_ref_kernel(const int8_t* __restrict__ ref_raw, const float2* __restrict__ F,
                   const float2* __restrict__ Tw, float2* __restrict__ R,
                   float* __restrict__ eref) {
  using S = TcMeasureSmem<M>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem + S::kTable);
  float* red = reinterpret_cast<float*>(smem + S::kTable + S::kWindow);

  const int t = blockIdx.x;
  load_table<M>(F, tab);
  load_window_i8<M>(ref_raw + static_cast<size_t>(t) * M * M, static_cast<size_t>(M) * M, win);
  __syncthreads();
  float2* Rt = R + static_cast<size_t>(t) * M * M;
  float e = 0.f;
  forward_tc<M>(tab, win, Tw, [&](int r, int c, float4 d) {
    *reinterpret_cast<float4*>(Rt + r * M + c) = d;
    e += d.x * d.x + d.y * d.y + d.z * d.z + d.w * d.w;
  });
  e = block_sum<kTcThreads<M>>(e, red);
  if (threadIdx.x == 0) eref[t] = e;
}

// The channel body: one CTA per window `win` of slot t. load(w) fills the
// window's swizzled planes at w; r_at(r, c) returns R's elements (r, c),
// (r, c + 1) as float4 (re, im, re, im); out.d(o, d) gets each pair of D
// elements at element offset o of the window's spectrum, and
// out.scalars(t, win, z, esig, eg) runs on thread 0 with the window's sums.
template <int M, class Load, class RAt, class Out>
__device__ __forceinline__ void measure_window(const float2* __restrict__ F,
                                               const float2* __restrict__ Tw, int t, size_t win,
                                               Load load, RAt r_at, Out out) {
  constexpr int W = M * M;
  constexpr int NT = kTcThreads<M>;
  using S = TcMeasureSmem<M>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* win_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kTable);
  float2* G = reinterpret_cast<float2*>(smem + S::kTable);  // over the window, after its use
  float2* aux = reinterpret_cast<float2*>(smem);            // over the table, after its use
  float* red = reinterpret_cast<float*>(smem + S::kTable + S::kWindow);

  load_table<M>(F, tab);
  load(win_s);
  __syncthreads();

  // Window spectrum D: handed to the writer, and G = D conj(R) kept in
  // float32.
  float esig = 0.f, eg = 0.f;
  forward_tc<M>(tab, win_s, Tw, [&](int r, int c, float4 d) {
    out.d(win * W + r * M + c, d);
    const float4 rr = r_at(r, c);
    const float g0re = d.x * rr.x + d.y * rr.y, g0im = d.y * rr.x - d.x * rr.y;
    const float g1re = d.z * rr.z + d.w * rr.w, g1im = d.w * rr.z - d.z * rr.w;
    *reinterpret_cast<float4*>(G + r * M + c) = make_float4(g0re, g0im, g1re, g1im);
    esig += d.x * d.x + d.y * d.y + d.z * d.z + d.w * d.w;
    eg += g0re * g0re + g0im * g0im + g1re * g1re + g1im * g1im;
  });
  __syncthreads();  // G complete; the table is free for aux

  const ZoomResult z = phase_zoom<M, NT>(G, aux, red);
  esig = block_sum<NT>(esig, red);
  eg = block_sum<NT>(eg, red);
  if (threadIdx.x == 0) out.scalars(t, win, z, esig, eg);
}

// The i8 channel kernels' outputs: lag, zre, zim, mag, papr float [T-1, N]
// against the reference energies eref, and with STORE_D the window
// spectrum D as bf16 (the handoff pair); without it the stores compile away
// and the two pointers are not read.
template <bool STORE_D>
struct I8Out {
  const float* eref;
  float *lag, *zre, *zim, *mag, *papr;
  __nv_bfloat16 *dre, *dim;

  __device__ __forceinline__ void d(size_t o, float4 v) const {
    if constexpr (STORE_D) {
      *reinterpret_cast<__nv_bfloat162*>(dre + o) = __floats2bfloat162_rn(v.x, v.z);
      *reinterpret_cast<__nv_bfloat162*>(dim + o) = __floats2bfloat162_rn(v.y, v.w);
    }
  }

  __device__ __forceinline__ void scalars(int t, size_t win, ZoomResult z, float esig,
                                          float eg) const {
    const float zabs = sqrtf(z.zre * z.zre + z.zim * z.zim);
    const float denom = sqrtf(esig * eref[t]);
    lag[win] = z.lag;
    zre[win] = z.zre;
    zim[win] = z.zim;
    mag[win] = zabs / fmaxf(denom, 1e-30f);
    papr[win] = zabs * zabs / fmaxf(eg, 1e-30f);
  }
};

// The float kernel's outputs: lag, |z|, sum |D|^2 and sum |G|^2 float
// [T-1, N]; no spectrum stored.
struct PlanesOut {
  float *lag, *zabs, *esig, *eg;

  __device__ __forceinline__ void d(size_t, float4) const {}

  __device__ __forceinline__ void scalars(int, size_t win, ZoomResult z, float e_sig,
                                          float e_g) const {
    lag[win] = z.lag;
    zabs[win] = sqrtf(z.zre * z.zre + z.zim * z.zim);
    esig[win] = e_sig;
    eg[win] = e_g;
  }
};

// Channel mode of the i8 path: int8 blocks raw [T, N, m/2, 2m] against R
// float2 [T-1, m, m] and eref from measure_ref_kernel. One CTA per (t, n) =
// (blockIdx.y, blockIdx.x).
template <int M, bool STORE_D>
__global__ void __launch_bounds__(kTcThreads<M>)
measure_kernel(const int8_t* __restrict__ raw, const float2* __restrict__ F,
               const float2* __restrict__ Tw, const float2* __restrict__ R,
               const float* __restrict__ eref, float* __restrict__ lag_out,
               float* __restrict__ zre_out, float* __restrict__ zim_out,
               float* __restrict__ mag_out, float* __restrict__ papr_out,
               __nv_bfloat16* __restrict__ dre_out, __nv_bfloat16* __restrict__ dim_out) {
  constexpr int W = M * M;
  const int n = blockIdx.x;
  const int N = gridDim.x;
  const int t = blockIdx.y;
  const size_t win = static_cast<size_t>(t) * N + n;
  const float2* Rt = R + static_cast<size_t>(t) * W;
  measure_window<M>(
      F, Tw, t, win,
      [&](__nv_bfloat16* w) { load_window_i8<M>(raw + win * W, static_cast<size_t>(N) * W, w); },
      [&](int r, int c) { return __ldg(reinterpret_cast<const float4*>(Rt + r * M + c)); },
      I8Out<STORE_D>{eref, lag_out, zre_out, zim_out, mag_out, papr_out, dre_out, dim_out});
}

// The float path: block planes pre/pim bf16 [T, N, m/2, m] against the
// reference spectra rre/rim bf16 [T-1, m, m]. One CTA per (t, n) =
// (blockIdx.y, blockIdx.x).
template <int M>
__global__ void __launch_bounds__(kTcThreads<M>)
measure_planes_kernel(const __nv_bfloat16* __restrict__ pre, const __nv_bfloat16* __restrict__ pim,
                      const __nv_bfloat16* __restrict__ rre, const __nv_bfloat16* __restrict__ rim,
                      const float2* __restrict__ F, const float2* __restrict__ Tw,
                      float* __restrict__ lag_out, float* __restrict__ zabs_out,
                      float* __restrict__ esig_out, float* __restrict__ eg_out) {
  constexpr int W = M * M;
  const int n = blockIdx.x;
  const int N = gridDim.x;
  const int t = blockIdx.y;
  const size_t win = static_cast<size_t>(t) * N + n;
  const size_t top = win * (W / 2);  // block t of channel n
  const unsigned int* Rre = reinterpret_cast<const unsigned int*>(rre + static_cast<size_t>(t) * W);
  const unsigned int* Rim = reinterpret_cast<const unsigned int*>(rim + static_cast<size_t>(t) * W);
  measure_window<M>(
      F, Tw, t, win,
      [&](__nv_bfloat16* w) {
        load_window_planes<M>(pre + top, pim + top, static_cast<size_t>(N) * (W / 2), w);
      },
      [&](int r, int c) {
        // Elements (r, c), (r, c + 1) of each plane, one bf16 pair a load
        // (c even), widened exactly.
        const float2 re = unpack_bf16(__ldg(Rre + (r * M + c) / 2));
        const float2 im = unpack_bf16(__ldg(Rim + (r * M + c) / 2));
        return make_float4(re.x, im.x, re.y, im.y);
      },
      PlanesOut{lag_out, zabs_out, esig_out, eg_out});
}

template <int M>
int launch_ref(const void* ref_raw, const void* F, const void* Tw, void* R, void* eref, int T1,
               void* stream) {
  const int smem = static_cast<int>(TcMeasureSmem<M>::kBytes);
  const cudaError_t err = set_smem(measure_ref_kernel<M>, smem);
  if (err != cudaSuccess) return err;
  measure_ref_kernel<M><<<T1, kTcThreads<M>, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ref_raw), static_cast<const float2*>(F),
      static_cast<const float2*>(Tw), static_cast<float2*>(R), static_cast<float*>(eref));
  return cudaGetLastError();
}

template <int M, bool STORE_D>
int launch(const void* raw, const void* F, const void* Tw, const void* R, const void* eref,
           void* lag, void* zre, void* zim, void* mag, void* papr, void* dre, void* dim, int T1,
           int N, void* stream) {
  const int smem = static_cast<int>(TcMeasureSmem<M>::kBytes);
  const cudaError_t err = set_smem(measure_kernel<M, STORE_D>, smem);
  if (err != cudaSuccess) return err;
  measure_kernel<M, STORE_D>
      <<<dim3(N, T1), kTcThreads<M>, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(raw), static_cast<const float2*>(F),
      static_cast<const float2*>(Tw), static_cast<const float2*>(R),
      static_cast<const float*>(eref), static_cast<float*>(lag), static_cast<float*>(zre),
      static_cast<float*>(zim), static_cast<float*>(mag), static_cast<float*>(papr),
      static_cast<__nv_bfloat16*>(dre), static_cast<__nv_bfloat16*>(dim));
  return cudaGetLastError();
}

template <int M>
int launch_planes(const void* pre, const void* pim, const void* rre, const void* rim,
                  const void* F, const void* Tw, void* lag, void* zabs, void* esig, void* eg,
                  int T1, int N, void* stream) {
  const int smem = static_cast<int>(TcMeasureSmem<M>::kBytes);
  const cudaError_t err = set_smem(measure_planes_kernel<M>, smem);
  if (err != cudaSuccess) return err;
  measure_planes_kernel<M>
      <<<dim3(N, T1), kTcThreads<M>, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pre), static_cast<const __nv_bfloat16*>(pim),
      static_cast<const __nv_bfloat16*>(rre), static_cast<const __nv_bfloat16*>(rim),
      static_cast<const float2*>(F), static_cast<const float2*>(Tw), static_cast<float*>(lag),
      static_cast<float*>(zabs), static_cast<float*>(esig), static_cast<float*>(eg));
  return cudaGetLastError();
}

// --- m = 256: a window a cluster of four CTAs (fused_cluster.cuh).

// phase_zoom on a window spread over the cluster: this CTA (rank p) holds
// rows k2 in [64 p, 64 p + 64) of G (float2 [64][m], shared), which it
// deramps in place. The stage-1 bands (8 rows of a column) lie inside a row
// block, so only the products across a block boundary (band 8p with band
// 8p - 1 of rank p - 1; band 0 of column k1 with the last band of column
// k1 - 1, on rank 3) read another CTA's band sums. s1, the column sums of
// stage 2 and the final sums (z, and the caller's two in `extra`) are
// combined over the ranks in order, so every CTA derives the same integer
// lag and fraction. aux: 9.5 m float2 of free shared memory; part: 6
// floats the other CTAs read; red: the block_sum scratch.
__device__ __forceinline__ ZoomResult cluster_phase_zoom(float2* G, float2* aux, float* part,
                                                         float* red, float (&extra)[2]) {
  namespace cg = cooperative_groups;
  using namespace cl;
  constexpr int NT = kThreads;
  cg::cluster_group cluster = cg::this_cluster();
  const int p = static_cast<int>(cluster.block_rank());
  // --- stage 1: band sums g1[jl][k1] of the bands j = 8p + jl.
  float2* g1 = aux;
  for (int i = threadIdx.x; i < (kPart / 8) * kM; i += NT) {
    const int jl = i / kM, c = i % kM;
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 g = G[(8 * jl + q) * kM + c];
      sr += g.x;
      si += g.y;
    }
    g1[i] = make_float2(sr, si);
  }
  cluster.sync();
  const float2* g1_prev = cluster.map_shared_rank(g1, (p + kRanks - 1) % kRanks);
  float s1re = 0.f, s1im = 0.f;
  for (int i = threadIdx.x; i < (kPart / 8) * kM; i += NT) {
    const int jl = i / kM, c = i % kM;
    float2 prev;
    if (jl > 0) {
      prev = g1[i - kM];
    } else if (p > 0) {
      prev = g1_prev[(kPart / 8 - 1) * kM + c];
    } else if (c >= 1 && c - 1 != kM / 2 - 1) {
      prev = g1_prev[(kPart / 8 - 1) * kM + c - 1];
    } else {
      continue;
    }
    const float2 cur = g1[i];
    s1re += cur.x * prev.x + cur.y * prev.y;
    s1im += cur.y * prev.x - cur.x * prev.y;
  }
  s1re = block_sum<NT>(s1re, red);
  s1im = block_sum<NT>(s1im, red);
  if (threadIdx.x == 0) {
    part[0] = s1re;
    part[1] = s1im;
  }
  cluster.sync();
  float s1[2];
  cluster_sum(part, s1);
  constexpr float kStage1 = static_cast<float>((kW / 8) / 6.283185307179586);
  const float int_lag = rintf(-atan2f(s1[1], s1[0]) * kStage1);

  // --- stage 2: deramp this block of G by the integer lag, in place.
  const int neg_lag = -static_cast<int>(int_lag);
  for (int i = threadIdx.x; i < kPart * kM; i += NT) {
    const int r = i / kM, c = i % kM;
    float s, co;
    sincospif(2.f * iramp_fraction<kW>(static_cast<uint32_t>(kPart * p + r + kM * c), neg_lag),
              &s, &co);
    const float2 g = G[i];
    G[i] = make_float2(g.x * co + g.y * s, g.y * co - g.x * s);
  }
  __syncthreads();
  // Column sums of the block, then (every CTA alike) the pair sums over the
  // four blocks, g2[b] = col[2b] + col[2b + 1].
  float2* col = aux + (kPart / 8) * kM;
  float2* g2 = col + kM;
  if (threadIdx.x < kM) {
    float sr = 0.f, si = 0.f;
    for (int r = 0; r < kPart; ++r) {
      const float2 g = G[r * kM + threadIdx.x];
      sr += g.x;
      si += g.y;
    }
    col[threadIdx.x] = make_float2(sr, si);
  }
  cluster.sync();
  if (threadIdx.x < kM / 2) {
    float sr = 0.f, si = 0.f;
    for (int r = 0; r < kRanks; ++r) {
      const float2* rc = cluster.map_shared_rank(col, r);
      const float2 a = rc[2 * threadIdx.x], b = rc[2 * threadIdx.x + 1];
      sr += a.x + b.x;
      si += a.y + b.y;
    }
    g2[threadIdx.x] = make_float2(sr, si);
  }
  __syncthreads();
  constexpr int M2 = kM / 2;
  float s2re = 0.f, s2im = 0.f;
  for (int b = 1; b < M2; ++b) {
    if (b - 1 == M2 / 2 - 1) continue;
    const float2 cur = g2[b];
    const float2 prev = g2[b - 1];
    s2re += cur.x * prev.x + cur.y * prev.y;
    s2im += cur.y * prev.x - cur.x * prev.y;
  }
  constexpr float kStage2 = static_cast<float>(M2 / 6.283185307179586);
  const float frac = fminf(fmaxf(-atan2f(s2im, s2re) * kStage2, -4.f), 4.f);

  // --- z = sum Gc e^{2 pi i frac f} over the block, then over the cluster.
  const float w = 2.f * frac;
  float zre = 0.f, zim = 0.f;
  for (int i = threadIdx.x; i < kPart * kM; i += NT) {
    const int r = i / kM, c = i % kM;
    float s, co;
    sincospif(w * signed_freq<kW>(static_cast<uint32_t>(kPart * p + r + kM * c)), &s, &co);
    const float2 g = G[i];
    zre += g.x * co - g.y * s;
    zim += g.x * s + g.y * co;
  }
  zre = block_sum<NT>(zre, red);
  zim = block_sum<NT>(zim, red);
  if (threadIdx.x == 0) {
    part[2] = zre;
    part[3] = zim;
    part[4] = extra[0];
    part[5] = extra[1];
  }
  cluster.sync();
  float v[4];
  cluster_sum(part + 2, v);
  extra[0] = v[2];
  extra[1] = v[3];
  cluster.sync();   // every CTA has read every part: the CTAs may leave
  return ZoomResult{int_lag + frac, v[0], v[1]};
}

// Shared memory of the m = 256 measure kernels: X, Y, Z (64 kB each; see
// forward_cluster; the table ring's slots in Z, G over Y and Z once the
// products are done), then the block_sum scratch, the partial sums the
// other CTAs read and the ring's barriers.
struct MeasureClusterSmem {
  static constexpr size_t kX = 0, kY = cl::kBuf, kZ = 2 * cl::kBuf;
  static_assert(cl::kRingBytes <= cl::kBuf, "the ring fits in Z");
  static constexpr size_t kRed = 3 * cl::kBuf;
  static constexpr size_t kPartOff = kRed + cl::kWarps * sizeof(float);
  static constexpr size_t kBars = kPartOff + 8 * sizeof(float);
  static constexpr size_t kBytes = kBars + cl::kRingBarBytes;
};

// m = 256, reference mode: the cluster of window t (blockIdx.y) writes R[t]
// (float2 [m, m]) and eref[t] = sum |R|^2.
__global__ void __cluster_dims__(cl::kRanks, 1, 1) __launch_bounds__(cl::kThreads, 1)
measure_ref_cluster_kernel(const int8_t* __restrict__ ref_raw,
                           const __nv_bfloat16* __restrict__ F, const float2* __restrict__ Tw,
                           float2* __restrict__ R, float* __restrict__ eref) {
  using S = MeasureClusterSmem;
  using namespace cl;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(smem + S::kX);
  __nv_bfloat16* Y = reinterpret_cast<__nv_bfloat16*>(smem + S::kY);
  float* red = reinterpret_cast<float*>(smem + S::kRed);
  float* part = reinterpret_cast<float*>(smem + S::kPartOff);
  using TabRing = Ring<S::kZ, S::kBars, 1>;
  TabRing::start(F, F);

  const int t = blockIdx.y;
  const int p = TabRing::rank();
  float2* Rt = R + static_cast<size_t>(t) * kW + static_cast<size_t>(kPart) * p * kM;
  float e = 0.f;
  forward_cluster<TabRing>(StripI8{ref_raw + static_cast<size_t>(t) * kW, kW}, 0, Tw, X, Y,
                  [&](int r, int c, float4 d) {
                    *reinterpret_cast<float4*>(Rt + r * kM + c) = d;
                    e += d.x * d.x + d.y * d.y + d.z * d.z + d.w * d.w;
                  });
  e = block_sum<kThreads>(e, red);
  if (threadIdx.x == 0) part[0] = e;
  cooperative_groups::this_cluster().sync();
  if (p == 0 && threadIdx.x == 0) {
    float v[1];
    cluster_sum(part, v);
    eref[t] = v[0];
  }
  cooperative_groups::this_cluster().sync();   // rank 0 has read every part
}

// The m = 256 channel body: the cluster of window `win` of slot t. load is
// the window's strip loader; r_at(r, c) returns R's elements (r, c), (r, c
// + 1) of this CTA's row block (k2 = 64 p + r) as float4 (re, im, re, im);
// out.d(o, d) gets each pair of D elements at element offset o of the
// window's spectrum, and out.scalars(t, win, z, esig, eg) runs on thread 0
// of rank 0 with the window's sums.
template <class Load, class RAt, class Out>
__device__ __forceinline__ void measure_cluster_window(const Load& load,
                                                       const __nv_bfloat16* __restrict__ F,
                                                       const float2* __restrict__ Tw, int t,
                                                       size_t win, RAt&& r_at, const Out& out) {
  using S = MeasureClusterSmem;
  using namespace cl;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(smem + S::kX);
  __nv_bfloat16* Y = reinterpret_cast<__nv_bfloat16*>(smem + S::kY);
  float2* G = reinterpret_cast<float2*>(smem + S::kY);   // over Y and Z: [64][m]
  float2* aux = reinterpret_cast<float2*>(smem + S::kX);  // over X, after the products
  float* red = reinterpret_cast<float*>(smem + S::kRed);
  float* part = reinterpret_cast<float*>(smem + S::kPartOff);
  using TabRing = Ring<S::kZ, S::kBars, 1>;
  TabRing::start(F, F);

  const int p = TabRing::rank();
  const size_t row0 = static_cast<size_t>(kPart) * p * kM;   // this block's first element
  // D's row block staged as float32 over Y and Z (where G goes), then one
  // pass of 16-byte pairs, row-major: D stored, G = D conj(R) in place,
  // the energies. (The staging keeps the epilogue's loads and registers
  // apart from the products' accumulators.)
  forward_cluster<TabRing>(load, 0, Tw, X, Y, [&](int r, int c, float4 d) {
    *reinterpret_cast<float4*>(G + r * kM + c) = d;
  });
  __syncthreads();
  float esig = 0.f, eg = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < kPart * kM / 2; i += kThreads) {
    const int r = 2 * i / kM, c = 2 * i % kM;
    float4* gp = reinterpret_cast<float4*>(G + r * kM + c);
    const float4 d = *gp;
    out.d(win * kW + row0 + r * kM + c, d);
    const float4 rr = r_at(r, c);
    const float g0re = d.x * rr.x + d.y * rr.y, g0im = d.y * rr.x - d.x * rr.y;
    const float g1re = d.z * rr.z + d.w * rr.w, g1im = d.w * rr.z - d.z * rr.w;
    *gp = make_float4(g0re, g0im, g1re, g1im);
    esig += d.x * d.x + d.y * d.y + d.z * d.z + d.w * d.w;
    eg += g0re * g0re + g0im * g0im + g1re * g1re + g1im * g1im;
  }
  float sums[2] = {block_sum<kThreads>(esig, red), block_sum<kThreads>(eg, red)};
  // block_sum's barriers: G complete, X free for aux.
  const ZoomResult z = cluster_phase_zoom(G, aux, part, red, sums);
  if (p == 0 && threadIdx.x == 0) out.scalars(t, win, z, sums[0], sums[1]);
}

// m = 256, channel mode of the i8 path: the cluster of window (t, n) =
// (blockIdx.y, blockIdx.x / 4) against R and eref from
// measure_ref_cluster_kernel; the outputs of measure_kernel<256, STORE_D>.
template <bool STORE_D>
__global__ void __cluster_dims__(cl::kRanks, 1, 1) __launch_bounds__(cl::kThreads, 1)
measure_cluster_kernel(const int8_t* __restrict__ raw, const __nv_bfloat16* __restrict__ F,
                       const float2* __restrict__ Tw, const float2* __restrict__ R,
                       const float* __restrict__ eref, float* __restrict__ lag_out,
                       float* __restrict__ zre_out, float* __restrict__ zim_out,
                       float* __restrict__ mag_out, float* __restrict__ papr_out,
                       __nv_bfloat16* __restrict__ dre_out, __nv_bfloat16* __restrict__ dim_out) {
  using namespace cl;
  const int N = gridDim.x / kRanks;
  const int t = blockIdx.y;
  const size_t win = static_cast<size_t>(t) * N + blockIdx.x / kRanks;
  const int p = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const float2* Rt = R + static_cast<size_t>(t) * kW + static_cast<size_t>(kPart) * p * kM;
  measure_cluster_window(
      StripI8{raw + win * kW, static_cast<size_t>(N) * kW}, F, Tw, t, win,
      [&](int r, int c) { return __ldg(reinterpret_cast<const float4*>(Rt + r * kM + c)); },
      I8Out<STORE_D>{eref, lag_out, zre_out, zim_out, mag_out, papr_out, dre_out, dim_out});
}

// m = 256, the float path: the cluster of window (t, n) = (blockIdx.y,
// blockIdx.x / 4) of the block planes pre/pim bf16 [T, N, m/2, m] against
// the reference spectra rre/rim bf16 [T-1, m, m]; the outputs of
// measure_planes_kernel.
__global__ void __cluster_dims__(cl::kRanks, 1, 1) __launch_bounds__(cl::kThreads, 1)
measure_planes_cluster_kernel(const __nv_bfloat16* __restrict__ pre,
                              const __nv_bfloat16* __restrict__ pim,
                              const __nv_bfloat16* __restrict__ rre,
                              const __nv_bfloat16* __restrict__ rim,
                              const __nv_bfloat16* __restrict__ F, const float2* __restrict__ Tw,
                              float* __restrict__ lag_out, float* __restrict__ zabs_out,
                              float* __restrict__ esig_out, float* __restrict__ eg_out) {
  using namespace cl;
  const int N = gridDim.x / kRanks;
  const int t = blockIdx.y;
  const size_t win = static_cast<size_t>(t) * N + blockIdx.x / kRanks;
  const size_t top = win * (kW / 2);   // block t of channel n
  const int p = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const size_t rt = static_cast<size_t>(t) * kW + static_cast<size_t>(kPart) * p * kM;
  const unsigned int* Rre = reinterpret_cast<const unsigned int*>(rre + rt);
  const unsigned int* Rim = reinterpret_cast<const unsigned int*>(rim + rt);
  measure_cluster_window(
      StripPlanes{pre + top, pim + top, static_cast<size_t>(N) * (kW / 2)}, F, Tw, t, win,
      [&](int r, int c) {
        // Elements (r, c), (r, c + 1) of each plane, one bf16 pair a load
        // (c even), widened exactly.
        const float2 re = unpack_bf16(__ldg(Rre + (r * kM + c) / 2));
        const float2 im = unpack_bf16(__ldg(Rim + (r * kM + c) / 2));
        return make_float4(re.x, im.x, re.y, im.y);
      },
      PlanesOut{lag_out, zabs_out, esig_out, eg_out});
}

int launch_ref_cluster(const void* ref_raw, const void* F, const void* Tw, void* R, void* eref,
                       int T1, void* stream) {
  const int smem = static_cast<int>(MeasureClusterSmem::kBytes);
  const cudaError_t err = set_smem(measure_ref_cluster_kernel, smem);
  if (err != cudaSuccess) return err;
  measure_ref_cluster_kernel<<<dim3(cl::kRanks, T1), cl::kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ref_raw), static_cast<const __nv_bfloat16*>(F),
      static_cast<const float2*>(Tw), static_cast<float2*>(R), static_cast<float*>(eref));
  return cudaGetLastError();
}

template <bool STORE_D>
int launch_cluster(const void* raw, const void* F, const void* Tw, const void* R,
                   const void* eref, void* lag, void* zre, void* zim, void* mag, void* papr,
                   void* dre, void* dim, int T1, int N, void* stream) {
  const int smem = static_cast<int>(MeasureClusterSmem::kBytes);
  const cudaError_t err = set_smem(measure_cluster_kernel<STORE_D>, smem);
  if (err != cudaSuccess) return err;
  measure_cluster_kernel<STORE_D><<<dim3(cl::kRanks * N, T1), cl::kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(raw), static_cast<const __nv_bfloat16*>(F),
      static_cast<const float2*>(Tw), static_cast<const float2*>(R),
      static_cast<const float*>(eref), static_cast<float*>(lag), static_cast<float*>(zre),
      static_cast<float*>(zim), static_cast<float*>(mag), static_cast<float*>(papr),
      static_cast<__nv_bfloat16*>(dre), static_cast<__nv_bfloat16*>(dim));
  return cudaGetLastError();
}

int launch_planes_cluster(const void* pre, const void* pim, const void* rre, const void* rim,
                          const void* F, const void* Tw, void* lag, void* zabs, void* esig,
                          void* eg, int T1, int N, void* stream) {
  const int smem = static_cast<int>(MeasureClusterSmem::kBytes);
  const cudaError_t err = set_smem(measure_planes_cluster_kernel, smem);
  if (err != cudaSuccess) return err;
  measure_planes_cluster_kernel<<<dim3(cl::kRanks * N, T1), cl::kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pre), static_cast<const __nv_bfloat16*>(pim),
      static_cast<const __nv_bfloat16*>(rre), static_cast<const __nv_bfloat16*>(rim),
      static_cast<const __nv_bfloat16*>(F), static_cast<const float2*>(Tw),
      static_cast<float*>(lag),
      static_cast<float*>(zabs), static_cast<float*>(esig), static_cast<float*>(eg));
  return cudaGetLastError();
}

}  // namespace fused

// ref_raw int8 [T, m/2, 2m]; tables F, Tw float2 [m, m] (at m = 256 F as
// the packed bf16 k-slices of kernels/fused.py:cluster_slices); outputs R float2
// [T-1, m, m] and eref float [T-1]; m in {64, 128, 256}. Returns the CUDA
// error code of the launch (0 on success); -1 for an unsupported m.
extern "C" int fused_measure_ref(const void* ref_raw, const void* F, const void* Tw, void* R,
                                 void* eref, int T1, int m, void* stream) {
  switch (m) {
    case 64:
      return fused::launch_ref<64>(ref_raw, F, Tw, R, eref, T1, stream);
    case 128:
      return fused::launch_ref<128>(ref_raw, F, Tw, R, eref, T1, stream);
    case 256:
      return fused::launch_ref_cluster(ref_raw, F, Tw, R, eref, T1, stream);
    default:
      return -1;
  }
}

// raw int8 [T, N, m/2, 2m]; tables F, Tw float2 [m, m] (at m = 256 F as the
// packed bf16 k-slices of kernels/fused.py:cluster_slices); R float2 [T-1, m, m]
// and eref float [T-1] from fused_measure_ref; outputs lag, zre, zim, mag,
// papr float [T-1, N] and dre, dim bf16 [T-1, N, m, m]; m in {64, 128,
// 256}. Returns the CUDA error code of the launch (0 on success); -1 for an
// unsupported m.
extern "C" int fused_measure_i8_spec(const void* raw, const void* F, const void* Tw,
                                     const void* R, const void* eref, void* lag, void* zre,
                                     void* zim, void* mag, void* papr, void* dre, void* dim,
                                     int T1, int N, int m, void* stream) {
  switch (m) {
    case 64:
      return fused::launch<64, true>(raw, F, Tw, R, eref, lag, zre, zim, mag, papr, dre, dim, T1,
                                     N, stream);
    case 128:
      return fused::launch<128, true>(raw, F, Tw, R, eref, lag, zre, zim, mag, papr, dre, dim, T1,
                                      N, stream);
    case 256:
      return fused::launch_cluster<true>(raw, F, Tw, R, eref, lag, zre, zim, mag, papr, dre, dim,
                                         T1, N, stream);
    default:
      return -1;
  }
}

// fused_measure_i8_spec without the spectrum: the same inputs and five
// scalar outputs, no D stored. Returns the CUDA error code of the launch
// (0 on success); -1 for an unsupported m.
extern "C" int fused_measure_i8(const void* raw, const void* F, const void* Tw, const void* R,
                                const void* eref, void* lag, void* zre, void* zim, void* mag,
                                void* papr, int T1, int N, int m, void* stream) {
  switch (m) {
    case 64:
      return fused::launch<64, false>(raw, F, Tw, R, eref, lag, zre, zim, mag, papr, nullptr,
                                      nullptr, T1, N, stream);
    case 128:
      return fused::launch<128, false>(raw, F, Tw, R, eref, lag, zre, zim, mag, papr, nullptr,
                                       nullptr, T1, N, stream);
    case 256:
      return fused::launch_cluster<false>(raw, F, Tw, R, eref, lag, zre, zim, mag, papr, nullptr,
                                          nullptr, T1, N, stream);
    default:
      return -1;
  }
}

// pre, pim bf16 [T, N, m/2, m]; rre, rim bf16 [T-1, m, m]; tables F, Tw
// float2 [m, m] (at m = 256 F as the packed bf16 k-slices of
// kernels/fused.py:cluster_slices); outputs lag, zabs, esig, eg float [T-1, N]; m in {64,
// 128, 256}. Returns the CUDA error code of the launch (0 on success); -1
// for an unsupported m.
extern "C" int fused_measure_planes(const void* pre, const void* pim, const void* rre,
                                    const void* rim, const void* F, const void* Tw, void* lag,
                                    void* zabs, void* esig, void* eg, int T1, int N, int m,
                                    void* stream) {
  switch (m) {
    case 64:
      return fused::launch_planes<64>(pre, pim, rre, rim, F, Tw, lag, zabs, esig, eg, T1, N,
                                      stream);
    case 128:
      return fused::launch_planes<128>(pre, pim, rre, rim, F, Tw, lag, zabs, esig, eg, T1, N,
                                       stream);
    case 256:
      return fused::launch_planes_cluster(pre, pim, rre, rim, F, Tw, lag, zabs, esig, eg, T1, N,
                                          stream);
    default:
      return -1;
  }
}
