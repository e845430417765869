// Fused i8 apply kernel: fractional-advance ramp times the phase factor on
// the stored window spectrum, inverse four-step FFT of the overlap-save
// centre rows only, round half to even x127, saturate, re-interleave to
// int8 wire bytes.
//
// Replaces coherent_rtlsdr_tpu/kernels/pallas_fused.py:_apply_spec_kernel_i8
// (FusedPipelineKernels.apply_spec_i8). Plain PyTorch version:
// coherent_rtlsdr_tpu_torch/kernels/fused.py:apply_spec_i8_plain.
//
// Design. One CTA of 256 threads per (window t, channel n). What bounds it
// on the H100: the SIMT FMA work of C2 = G Fi (16.8 MFLOP a window at
// m = 128) and of the centre rows y = Fi[m/4:3m/4] B2 (8.4 MFLOP); the
// bytes are 64 kB of D in and 16 kB of wire bytes out. Both intermediate
// bf16 matrices stay in shared memory (2 x 66 kB at m = 128); the ramp is
// built per element from the advance (exact integer part, then the
// fractional part times the signed frequency), so no ramp table is read.

#include "fused_common.cuh"

namespace fused {

template <int M>
struct ApplySmem {
  static constexpr size_t kBytes = 2 * SmemBf16Matrix<M>::kBytes;
};

template <int M>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const __nv_bfloat16* __restrict__ dre, const __nv_bfloat16* __restrict__ dim,
             const float* __restrict__ advance, const float* __restrict__ phase_re,
             const float* __restrict__ phase_im, const float2* __restrict__ Fi,
             const float2* __restrict__ Tw, int8_t* __restrict__ out) {
  constexpr int W = M * M;
  extern __shared__ __align__(16) unsigned char smem[];
  SmemBf16Matrix<M> G{reinterpret_cast<__nv_bfloat162*>(smem)};
  SmemBf16Matrix<M> B{reinterpret_cast<__nv_bfloat162*>(smem + SmemBf16Matrix<M>::kBytes)};

  const int n = blockIdx.x;
  const int N = gridDim.x;
  const int t = blockIdx.y;
  const size_t win = static_cast<size_t>(t) * N + n;
  const __nv_bfloat16* Dre = dre + win * W;
  const __nv_bfloat16* Dim = dim + win * W;

  // Ramp exp(-2 pi i (iramp(floor(d)) + f frac(d))) for delay d = -advance,
  // times the phase factor p. The explicit _rn operations keep the compiler
  // from contracting the phase into an FMA, so it rounds as the plain
  // version does.
  const float d = -advance[win];
  const float di = floorf(d);
  const float df = d - di;
  const int d_int = static_cast<int>(di);
  const float p_re = phase_re[win];
  const float p_im = phase_im[win];
  for (int i = threadIdx.x; i < W; i += kThreads) {
    const int r = i / M;
    const int c = i % M;
    const uint32_t k = static_cast<uint32_t>(r + M * c);
    const float ph = __fmul_rn(
        __fadd_rn(iramp_fraction<W>(k, d_int), __fmul_rn(signed_freq<W>(k), df)), kTwoPi);
    float s, co;
    sincosf(ph, &s, &co);
    const float wr = co * p_re + s * p_im;   // (co - i s) (p_re + i p_im)
    const float wi = co * p_im - s * p_re;
    const float gr = __bfloat162float(Dre[i]);
    const float gi = __bfloat162float(Dim[i]);
    G.set(r, c, gr * wr - gi * wi, gr * wi + gi * wr);
  }
  __syncthreads();

  // C2 = G Fi (Fi = conj(F)/m), then B2 = bf16(C2 conj(T)).
  cmatmul<M / 16, M / 16, M>(
      [&](int r, int k) { return G.get(r, k); },
      [&](int k, int c) { return Fi[k * M + c]; },
      [&](int r, int c, float cre, float cim) {
        const float2 tw = Tw[r * M + c];
        B.set(r, c, cre * tw.x + cim * tw.y, cim * tw.x - cre * tw.y);
      });
  __syncthreads();

  // Centre rows only: y[r] = sum_k Fi[m/4 + r, k] B2[k, :] for r < m/2 (Fi
  // is symmetric, so read row k). Quantize and interleave straight to the
  // wire block [m/2, 2m].
  int8_t* o = out + win * W;
  cmatmul<M / 32, M / 16, M>(
      [&](int r, int k) { return Fi[k * M + M / 4 + r]; },
      [&](int k, int c) { return B.get(k, c); },
      [&](int r, int c, float yre, float yim) {
        const float qre = fminf(fmaxf(rintf(yre * 127.0f), -128.f), 127.f);
        const float qim = fminf(fmaxf(rintf(yim * 127.0f), -128.f), 127.f);
        reinterpret_cast<char2*>(o)[r * M + c] =
            make_char2(static_cast<signed char>(qre), static_cast<signed char>(qim));
      });
}

template <int M>
int launch(const void* dre, const void* dim, const void* advance, const void* phase_re,
           const void* phase_im, const void* Fi, const void* Tw, void* out, int T1, int N,
           void* stream) {
  const int smem = static_cast<int>(ApplySmem<M>::kBytes);
  cudaError_t err =
      cudaFuncSetAttribute(apply_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  apply_kernel<M><<<dim3(N, T1), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dre), static_cast<const __nv_bfloat16*>(dim),
      static_cast<const float*>(advance), static_cast<const float*>(phase_re),
      static_cast<const float*>(phase_im), static_cast<const float2*>(Fi),
      static_cast<const float2*>(Tw), static_cast<int8_t*>(out));
  return cudaGetLastError();
}

}  // namespace fused

// dre, dim bf16 [T-1, N, m, m]; advance, phase_re, phase_im float [T-1, N];
// tables Fi (bf16-rounded conj(F)/m) and Tw float2 [m, m]; out int8
// [T-1, N, m/2, 2m]. Returns the CUDA error code of the launch (0 on
// success); -1 for an unsupported m.
extern "C" int fused_apply_spec_i8(const void* dre, const void* dim, const void* advance,
                                   const void* phase_re, const void* phase_im, const void* Fi,
                                   const void* Tw, void* out, int T1, int N, int m,
                                   void* stream) {
  switch (m) {
    case 64:
      return fused::launch<64>(dre, dim, advance, phase_re, phase_im, Fi, Tw, out, T1, N, stream);
    case 128:
      return fused::launch<128>(dre, dim, advance, phase_re, phase_im, Fi, Tw, out, T1, N,
                                stream);
    default:
      return -1;
  }
}
