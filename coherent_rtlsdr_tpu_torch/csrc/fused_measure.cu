// Fused i8 measure kernel: dequant + de-interleave, forward four-step FFT of
// each overlap-save window, cross-spectrum with the reference window, the
// two-stage phase-zoom lag estimator, and the stored bf16 window spectrum.
//
// Replaces coherent_rtlsdr_tpu/kernels/pallas_fused.py:_measure_kernel_i8_spec
// (FusedPipelineKernels.measure_i8_spec). Plain PyTorch versions:
// coherent_rtlsdr_tpu_torch/kernels/fused.py:measure_ref_plain and
// measure_spec_plain.
//
// Design. One CTA of 256 threads per (window t, channel n). On the TPU one
// grid step carried the reference spectrum R across its channels; CUDA
// blocks share nothing, so a first kernel, the same code in reference mode
// (fused_measure_ref), writes R (float32) and its energy per window, and the
// channel kernel (fused_measure_i8_spec) reads them. What bounds the kernel on
// the H100: the four real m^3 products of each transform (2 x 16.8 MFLOP a
// window at m = 128) run on the SIMT FMA units, so it is compute-bound at
// ~2 FMA per shared-memory load; the bytes (32 kB in, 64 kB of D out, 128 kB
// of R read from L2) are small beside that. Everything between the raw bytes
// and the five scalars stays in shared memory, 197,152 bytes at m = 128:
//   region A (m*m float2):  the dequantized window A, then G = D conj(R)
//   region C (m*(m+1) bf16x2): C = bf16(B * T), then the stage-1 band sums
// Tensor-core products (mma/wgmma) and pipelined loads are later work.

#include "fused_common.cuh"

namespace fused {

template <int M>
struct MeasureSmem {
  static constexpr size_t kRegionA = sizeof(float2) * M * M;
  static constexpr size_t kRegionC = SmemBf16Matrix<M>::kBytes;
  static constexpr size_t kBytes = kRegionA + kRegionC + sizeof(float) * (kThreads / 32);
};

// Window (t, n): rows 0..m/2-1 from block `top`, rows m/2..m-1 from the
// next block (`top + next`). Fills A with bf16(float(i8) * (1/127)) as
// float2 (re, im), then runs B = F A, C = bf16(B * T), D = C F.
// Hands each D element to d_epi(r, c, re, im).
template <int M, class DEpi>
__device__ __forceinline__ void forward_fft(const int8_t* __restrict__ top, size_t next,
                                            const float2* __restrict__ F,
                                            const float2* __restrict__ Tw, float2* A,
                                            SmemBf16Matrix<M> C, DEpi d_epi) {
  constexpr float kScale = static_cast<float>(1.0 / 127.0);
  // 4 bytes (2 samples) per step; each half-window is m*m contiguous bytes.
  constexpr int kWords = M * M / 4;
  for (int w = threadIdx.x; w < 2 * kWords; w += kThreads) {
    const int half = w / kWords;
    const int wi = w - half * kWords;
    const char4 b = reinterpret_cast<const char4*>(top + half * next)[wi];
    const int s = 2 * wi;  // sample index within the half-window
    const int r = half * (M / 2) + s / M;
    const int c = s % M;
    A[r * M + c] = make_float2(bf16_round(b.x * kScale), bf16_round(b.y * kScale));
    A[r * M + c + 1] = make_float2(bf16_round(b.z * kScale), bf16_round(b.w * kScale));
  }
  __syncthreads();

  // B[k2, n1] = sum_n2 F[k2, n2] A[n2, n1]; F is symmetric, so read row n2.
  cmatmul<M / 16, M / 16, M>(
      [&](int r, int k) { return F[k * M + r]; },
      [&](int k, int c) { return A[k * M + c]; },
      [&](int r, int c, float bre, float bim) {
        const float2 t = Tw[r * M + c];
        C.set(r, c, bre * t.x - bim * t.y, bre * t.y + bim * t.x);
      });
  __syncthreads();

  // D[k2, k1] = sum_n1 C[k2, n1] F[n1, k1].
  cmatmul<M / 16, M / 16, M>(
      [&](int r, int k) { return C.get(r, k); },
      [&](int k, int c) { return F[k * M + c]; },
      d_epi);
  __syncthreads();
}

// Reference mode: one CTA per window t writes R[t] (float2 [m, m]) and
// eref[t] = sum |R|^2.
template <int M>
__global__ void __launch_bounds__(kThreads)
measure_ref_kernel(const int8_t* __restrict__ ref_raw, const float2* __restrict__ F,
                   const float2* __restrict__ Tw, float2* __restrict__ R,
                   float* __restrict__ eref) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* A = reinterpret_cast<float2*>(smem);
  SmemBf16Matrix<M> C{reinterpret_cast<__nv_bfloat162*>(smem + MeasureSmem<M>::kRegionA)};
  float* red = reinterpret_cast<float*>(smem + MeasureSmem<M>::kRegionA + MeasureSmem<M>::kRegionC);

  const int t = blockIdx.x;
  float2* Rt = R + static_cast<size_t>(t) * M * M;
  float e = 0.f;
  forward_fft<M>(ref_raw + static_cast<size_t>(t) * M * M, static_cast<size_t>(M) * M, F, Tw,
                 A, C, [&](int r, int c, float dre, float dim) {
                   Rt[r * M + c] = make_float2(dre, dim);
                   e += dre * dre + dim * dim;
                 });
  e = block_sum(e, red);
  if (threadIdx.x == 0) eref[t] = e;
}

// Channel mode: one CTA per (t, n) = (blockIdx.y, blockIdx.x).
template <int M>
__global__ void __launch_bounds__(kThreads)
measure_kernel(const int8_t* __restrict__ raw, const float2* __restrict__ F,
               const float2* __restrict__ Tw, const float2* __restrict__ R,
               const float* __restrict__ eref, float* __restrict__ lag_out,
               float* __restrict__ zre_out, float* __restrict__ zim_out,
               float* __restrict__ mag_out, float* __restrict__ papr_out,
               __nv_bfloat16* __restrict__ dre_out, __nv_bfloat16* __restrict__ dim_out) {
  constexpr int W = M * M;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* G = reinterpret_cast<float2*>(smem);  // region A: A, then G
  SmemBf16Matrix<M> C{reinterpret_cast<__nv_bfloat162*>(smem + MeasureSmem<M>::kRegionA)};
  float2* aux = reinterpret_cast<float2*>(smem + MeasureSmem<M>::kRegionA);  // region C, reused
  float* red = reinterpret_cast<float*>(smem + MeasureSmem<M>::kRegionA + MeasureSmem<M>::kRegionC);

  const int n = blockIdx.x;
  const int N = gridDim.x;
  const int t = blockIdx.y;
  const size_t win = static_cast<size_t>(t) * N + n;
  const float2* Rt = R + static_cast<size_t>(t) * M * M;
  __nv_bfloat16* Dre = dre_out + win * W;
  __nv_bfloat16* Dim = dim_out + win * W;

  // Window spectrum D: stored as bf16, and G = D conj(R) kept in float32.
  float esig = 0.f, eg = 0.f;
  forward_fft<M>(raw + win * W, static_cast<size_t>(N) * W, F, Tw, G, C,
                 [&](int r, int c, float dre, float dim) {
                   Dre[r * M + c] = __float2bfloat16_rn(dre);
                   Dim[r * M + c] = __float2bfloat16_rn(dim);
                   const float2 rr = Rt[r * M + c];
                   const float gre = dre * rr.x + dim * rr.y;
                   const float gim = dim * rr.x - dre * rr.y;
                   G[r * M + c] = make_float2(gre, gim);
                   esig += dre * dre + dim * dim;
                   eg += gre * gre + gim * gim;
                 });

  // --- stage 1: 8-bin bands are row groups of 8 within a column (band
  // b = k1*(m/8) + j); g1[j][k1] in region C.
  float2* g1 = aux;
  for (int i = threadIdx.x; i < (M / 8) * M; i += kThreads) {
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
  for (int i = threadIdx.x; i < (M / 8) * M; i += kThreads) {
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
  s1re = block_sum(s1re, red);
  s1im = block_sum(s1im, red);
  constexpr float kStage1 = static_cast<float>((W / 8) / 6.283185307179586);
  const float int_lag = rintf(-atan2f(s1im, s1re) * kStage1);

  // --- stage 2: deramp G by the integer lag, in place.
  const int neg_lag = -static_cast<int>(int_lag);
  for (int i = threadIdx.x; i < M * M; i += kThreads) {
    const int r = i / M;
    const int c = i % M;
    const float ph = iramp_fraction<W>(static_cast<uint32_t>(r + M * c), neg_lag) * kTwoPi;
    float s, co;
    sincosf(ph, &s, &co);
    const float2 g = G[i];
    G[i] = make_float2(g.x * co + g.y * s, g.y * co - g.x * s);  // G * (cos - i sin)
  }
  __syncthreads();
  // 2m-bin bands are column pairs: column sums (kP partial sums a column,
  // combined in a fixed order), then pair sums g2[b] = col[2b] + col[2b+1].
  constexpr int kP = kThreads / M;
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
  const float w = kTwoPi * frac;
  float zre = 0.f, zim = 0.f;
  for (int i = threadIdx.x; i < M * M; i += kThreads) {
    const int r = i / M;
    const int c = i % M;
    float s, co;
    sincosf(w * signed_freq<W>(static_cast<uint32_t>(r + M * c)), &s, &co);
    const float2 g = G[i];
    zre += g.x * co - g.y * s;
    zim += g.x * s + g.y * co;
  }
  zre = block_sum(zre, red);
  zim = block_sum(zim, red);
  esig = block_sum(esig, red);
  eg = block_sum(eg, red);

  if (threadIdx.x == 0) {
    const float zabs = sqrtf(zre * zre + zim * zim);
    const float denom = sqrtf(esig * eref[t]);
    lag_out[win] = int_lag + frac;
    zre_out[win] = zre;
    zim_out[win] = zim;
    mag_out[win] = zabs / fmaxf(denom, 1e-30f);
    papr_out[win] = zabs * zabs / fmaxf(eg, 1e-30f);
  }
}

template <int M>
int launch_ref(const void* ref_raw, const void* F, const void* Tw, void* R, void* eref, int T1,
               void* stream) {
  const int smem = static_cast<int>(MeasureSmem<M>::kBytes);
  const cudaError_t err = cudaFuncSetAttribute(measure_ref_kernel<M>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  measure_ref_kernel<M><<<T1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ref_raw), static_cast<const float2*>(F),
      static_cast<const float2*>(Tw), static_cast<float2*>(R), static_cast<float*>(eref));
  return cudaGetLastError();
}

template <int M>
int launch(const void* raw, const void* F, const void* Tw, const void* R, const void* eref,
           void* lag, void* zre, void* zim, void* mag, void* papr, void* dre, void* dim, int T1,
           int N, void* stream) {
  const int smem = static_cast<int>(MeasureSmem<M>::kBytes);
  const cudaError_t err = cudaFuncSetAttribute(measure_kernel<M>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  measure_kernel<M><<<dim3(N, T1), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(raw), static_cast<const float2*>(F),
      static_cast<const float2*>(Tw), static_cast<const float2*>(R),
      static_cast<const float*>(eref), static_cast<float*>(lag), static_cast<float*>(zre),
      static_cast<float*>(zim), static_cast<float*>(mag), static_cast<float*>(papr),
      static_cast<__nv_bfloat16*>(dre), static_cast<__nv_bfloat16*>(dim));
  return cudaGetLastError();
}

}  // namespace fused

// ref_raw int8 [T, m/2, 2m]; tables F, Tw float2 [m, m]; outputs R float2
// [T-1, m, m] and eref float [T-1]. Returns the CUDA error code of the
// launch (0 on success); -1 for an unsupported m.
extern "C" int fused_measure_ref(const void* ref_raw, const void* F, const void* Tw, void* R,
                                 void* eref, int T1, int m, void* stream) {
  switch (m) {
    case 64:
      return fused::launch_ref<64>(ref_raw, F, Tw, R, eref, T1, stream);
    case 128:
      return fused::launch_ref<128>(ref_raw, F, Tw, R, eref, T1, stream);
    default:
      return -1;
  }
}

// raw int8 [T, N, m/2, 2m]; tables F, Tw float2 [m, m]; R float2 [T-1, m, m]
// and eref float [T-1] from fused_measure_ref; outputs lag, zre, zim, mag,
// papr float [T-1, N] and dre, dim bf16 [T-1, N, m, m]. Returns the CUDA
// error code of the launch (0 on success); -1 for an unsupported m.
extern "C" int fused_measure_i8_spec(const void* raw, const void* F, const void* Tw,
                                     const void* R, const void* eref, void* lag, void* zre,
                                     void* zim, void* mag, void* papr, void* dre, void* dim,
                                     int T1, int N, int m, void* stream) {
  switch (m) {
    case 64:
      return fused::launch<64>(raw, F, Tw, R, eref, lag, zre, zim, mag, papr, dre, dim, T1, N,
                               stream);
    case 128:
      return fused::launch<128>(raw, F, Tw, R, eref, lag, zre, zim, mag, papr, dre, dim, T1, N,
                                stream);
    default:
      return -1;
  }
}
