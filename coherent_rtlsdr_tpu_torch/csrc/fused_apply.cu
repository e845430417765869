// Fused apply kernels: fractional-advance ramp on the window spectrum,
// inverse four-step FFT of the overlap-save centre rows only.
//
// Replaces, in coherent_rtlsdr_tpu/kernels/pallas_fused.py:
//   * _apply_spec_kernel_i8 (FusedPipelineKernels.apply_spec_i8): the stored
//     bf16 window spectrum in, the ramp times the phase factor, round half to
//     even x127, saturate, re-interleave to int8 wire bytes
//     (fused_apply_spec_i8);
//   * _apply_kernel_i8 (FusedPipelineKernels.apply_i8): the int8 blocks in,
//     the forward four-step recomputed in the kernel, the same ramp, phase
//     factor and wire epilogue on the float32 spectrum (fused_apply_i8);
//   * _apply_kernel (FusedPipelineKernels.apply): bf16 block planes in, the
//     forward four-step recomputed in the kernel, the ramp without a phase
//     factor, float32 centre rows out (fused_apply_planes).
// Plain PyTorch versions: coherent_rtlsdr_tpu_torch/kernels/fused.py
// (apply_spec_i8_plain, apply_i8_plain, apply_plain).
//
// Design. One CTA of 256 threads per (window t, channel n). What bounds it
// on the H100: the SIMT FMA work of the products, C2 = G Fi (16.8 MFLOP a
// window at m = 128) and the centre rows y = Fi[m/4:3m/4] B2 (8.4 MFLOP),
// plus the forward transform (33.6 MFLOP) where it is recomputed; the bytes
// are 64 kB (bf16 spectrum) or 32 kB (int8 window) in and 16 kB (int8) or
// 64 kB (float32) out a window. The intermediate matrices stay in shared
// memory. The ramp is built per element from the advance (exact integer
// part, then the fractional part times the signed frequency), so no ramp
// table is read.
//   spectrum in: G, B2 as padded bf16 matrices, 2 x 66 kB at m = 128;
//   window in:   forward_fft's regions (the window A as float2, then G as
//                bf16 in its place; C, then B2), 197,152 bytes at m = 128.

#include "fused_common.cuh"

namespace fused {

template <int M>
struct ApplySmem {
  static constexpr size_t kBytes = 2 * SmemBf16Matrix<M>::kBytes;
};

template <int M>
struct ApplyPlanesSmem {
  static constexpr size_t kRegionA = sizeof(float2) * M * M;
  static constexpr size_t kBytes = kRegionA + SmemBf16Matrix<M>::kBytes;
};

// Ramp phase (radians) of natural bin k for delay d = di + df (di integer,
// df in [0, 1)): 2 pi (iramp(k, di) + f_k df). The explicit _rn operations
// keep the compiler from contracting it into an FMA, so it rounds as the
// plain version does.
template <int W>
__device__ __forceinline__ float ramp_phase(uint32_t k, int d_int, float df) {
  return __fmul_rn(__fadd_rn(iramp_fraction<W>(k, d_int), __fmul_rn(signed_freq<W>(k), df)),
                   kTwoPi);
}

// The apply weight of natural bin k: the ramp exp(-i ramp_phase) times the
// phase factor p, (co - i s) (p_re + i p_im).
template <int W>
__device__ __forceinline__ float2 ramp_weight(uint32_t k, int d_int, float df, float p_re,
                                              float p_im) {
  float s, co;
  sincosf(ramp_phase<W>(k, d_int, df), &s, &co);
  return make_float2(co * p_re + s * p_im, co * p_im - s * p_re);
}

// The int8 wire epilogue of inverse_fft: round half to even x127, saturate,
// and interleave (re, im) of centre row r, column c into the wire block
// [m/2, 2m] at o.
template <int M>
struct WireStore {
  int8_t* o;
  __device__ __forceinline__ void operator()(int r, int c, float yre, float yim) const {
    const float qre = fminf(fmaxf(rintf(yre * 127.0f), -128.f), 127.f);
    const float qim = fminf(fmaxf(rintf(yim * 127.0f), -128.f), 127.f);
    reinterpret_cast<char2*>(o)[r * M + c] =
        make_char2(static_cast<signed char>(qre), static_cast<signed char>(qim));
  }
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
  // times the phase factor p.
  const float d = -advance[win];
  const float di = floorf(d);
  const float df = d - di;
  const int d_int = static_cast<int>(di);
  const float p_re = phase_re[win];
  const float p_im = phase_im[win];
  for (int i = threadIdx.x; i < W; i += kThreads) {
    const int r = i / M;
    const int c = i % M;
    const float2 w = ramp_weight<W>(static_cast<uint32_t>(r + M * c), d_int, df, p_re, p_im);
    const float gr = __bfloat162float(Dre[i]);
    const float gi = __bfloat162float(Dim[i]);
    G.set(r, c, gr * w.x - gi * w.y, gr * w.y + gi * w.x);
  }
  __syncthreads();

  // Centre rows only; quantize and interleave straight to the wire block
  // [m/2, 2m].
  inverse_fft<M, M / 2>(G, B, Fi, Tw, WireStore<M>{out + win * W});
}

// The recompute path: int8 blocks raw [T, N, m/2, 2m] and advance, phase_re,
// phase_im float [T-1, N]; writes int8 wire blocks out [T-1, N, m/2, 2m].
// The shared-memory plan of apply_planes_kernel: G = D ramp p is written as
// bf16 over region A while forward_fft's last product reads only C and F,
// and the inverse's B2 goes into C.
template <int M>
__global__ void __launch_bounds__(kThreads)
apply_i8_kernel(const int8_t* __restrict__ raw, const float* __restrict__ advance,
                const float* __restrict__ phase_re, const float* __restrict__ phase_im,
                const float2* __restrict__ F, const float2* __restrict__ Fi,
                const float2* __restrict__ Tw, int8_t* __restrict__ out) {
  constexpr int W = M * M;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* A = reinterpret_cast<float2*>(smem);
  SmemBf16Matrix<M> C{reinterpret_cast<__nv_bfloat162*>(smem + ApplyPlanesSmem<M>::kRegionA)};
  SmemBf16Matrix<M> G{reinterpret_cast<__nv_bfloat162*>(smem)};

  const int n = blockIdx.x;
  const int N = gridDim.x;
  const int t = blockIdx.y;
  const size_t win = static_cast<size_t>(t) * N + n;

  const float d = -advance[win];
  const float di = floorf(d);
  const float df = d - di;
  const int d_int = static_cast<int>(di);
  const float p_re = phase_re[win];
  const float p_im = phase_im[win];

  // The float32 D, not a bf16-rounded one, times the ramp and p.
  forward_fft<M>(
      [&](float2* a) { load_i8<M>(raw + win * W, static_cast<size_t>(N) * W, a); }, F, Tw, A,
      C, [&](int r, int c, float dre, float dim) {
        const float2 w = ramp_weight<W>(static_cast<uint32_t>(r + M * c), d_int, df, p_re, p_im);
        G.set(r, c, dre * w.x - dim * w.y, dre * w.y + dim * w.x);
      });

  inverse_fft<M, M / 2>(G, C, Fi, Tw, WireStore<M>{out + win * W});
}

// The float path: block planes pre/pim bf16 [T, N, m/2, m], advance float
// [T-1, N]; writes the centre half yre, yim float [T-1, N, m/2, m].
template <int M>
__global__ void __launch_bounds__(kThreads)
apply_planes_kernel(const __nv_bfloat16* __restrict__ pre, const __nv_bfloat16* __restrict__ pim,
                    const float* __restrict__ advance, const float2* __restrict__ F,
                    const float2* __restrict__ Fi, const float2* __restrict__ Tw,
                    float* __restrict__ yre_out, float* __restrict__ yim_out) {
  constexpr int W = M * M;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* A = reinterpret_cast<float2*>(smem);
  SmemBf16Matrix<M> C{reinterpret_cast<__nv_bfloat162*>(smem + ApplyPlanesSmem<M>::kRegionA)};
  // After the forward transform A is free (G goes there) and, once the
  // first inverse product has read G, so is C (B2 goes there).
  SmemBf16Matrix<M> G{reinterpret_cast<__nv_bfloat162*>(smem)};

  const int n = blockIdx.x;
  const int N = gridDim.x;
  const int t = blockIdx.y;
  const size_t win = static_cast<size_t>(t) * N + n;
  const size_t top = win * (W / 2);

  const float d = -advance[win];
  const float di = floorf(d);
  const float df = d - di;
  const int d_int = static_cast<int>(di);

  // G = D exp(-2 pi i (iramp(floor(d)) + f frac(d))), written as bf16 over
  // region A: forward_fft's last product reads only C and F.
  forward_fft<M>(
      [&](float2* a) { load_planes<M>(pre + top, pim + top, static_cast<size_t>(N) * (W / 2), a); },
      F, Tw, A, C, [&](int r, int c, float dre, float dim) {
        float s, co;
        sincosf(ramp_phase<W>(static_cast<uint32_t>(r + M * c), d_int, df), &s, &co);
        G.set(r, c, dre * co + dim * s, dim * co - dre * s);  // D (co - i s)
      });

  float* yr = yre_out + win * (W / 2);
  float* yi = yim_out + win * (W / 2);
  inverse_fft<M, M / 2>(G, C, Fi, Tw, [&](int r, int c, float yre, float yim) {
    yr[r * M + c] = yre;
    yi[r * M + c] = yim;
  });
}

template <int M>
int launch(const void* dre, const void* dim, const void* advance, const void* phase_re,
           const void* phase_im, const void* Fi, const void* Tw, void* out, int T1, int N,
           void* stream) {
  const int smem = static_cast<int>(ApplySmem<M>::kBytes);
  const cudaError_t err = set_smem(apply_kernel<M>, smem);
  if (err != cudaSuccess) return err;
  apply_kernel<M><<<dim3(N, T1), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dre), static_cast<const __nv_bfloat16*>(dim),
      static_cast<const float*>(advance), static_cast<const float*>(phase_re),
      static_cast<const float*>(phase_im), static_cast<const float2*>(Fi),
      static_cast<const float2*>(Tw), static_cast<int8_t*>(out));
  return cudaGetLastError();
}

template <int M>
int launch_i8(const void* raw, const void* advance, const void* phase_re, const void* phase_im,
              const void* F, const void* Fi, const void* Tw, void* out, int T1, int N,
              void* stream) {
  const int smem = static_cast<int>(ApplyPlanesSmem<M>::kBytes);
  const cudaError_t err = set_smem(apply_i8_kernel<M>, smem);
  if (err != cudaSuccess) return err;
  apply_i8_kernel<M><<<dim3(N, T1), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(raw), static_cast<const float*>(advance),
      static_cast<const float*>(phase_re), static_cast<const float*>(phase_im),
      static_cast<const float2*>(F), static_cast<const float2*>(Fi),
      static_cast<const float2*>(Tw), static_cast<int8_t*>(out));
  return cudaGetLastError();
}

template <int M>
int launch_planes(const void* pre, const void* pim, const void* advance, const void* F,
                  const void* Fi, const void* Tw, void* yre, void* yim, int T1, int N,
                  void* stream) {
  const int smem = static_cast<int>(ApplyPlanesSmem<M>::kBytes);
  const cudaError_t err = set_smem(apply_planes_kernel<M>, smem);
  if (err != cudaSuccess) return err;
  apply_planes_kernel<M><<<dim3(N, T1), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pre), static_cast<const __nv_bfloat16*>(pim),
      static_cast<const float*>(advance), static_cast<const float2*>(F),
      static_cast<const float2*>(Fi), static_cast<const float2*>(Tw), static_cast<float*>(yre),
      static_cast<float*>(yim));
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

// raw int8 [T, N, m/2, 2m]; advance, phase_re, phase_im float [T-1, N];
// tables F, Fi (bf16-rounded) and Tw float2 [m, m]; out int8
// [T-1, N, m/2, 2m]. Returns the CUDA error code of the launch (0 on
// success); -1 for an unsupported m.
extern "C" int fused_apply_i8(const void* raw, const void* advance, const void* phase_re,
                              const void* phase_im, const void* F, const void* Fi,
                              const void* Tw, void* out, int T1, int N, int m, void* stream) {
  switch (m) {
    case 64:
      return fused::launch_i8<64>(raw, advance, phase_re, phase_im, F, Fi, Tw, out, T1, N,
                                  stream);
    case 128:
      return fused::launch_i8<128>(raw, advance, phase_re, phase_im, F, Fi, Tw, out, T1, N,
                                   stream);
    default:
      return -1;
  }
}

// pre, pim bf16 [T, N, m/2, m]; advance float [T-1, N]; tables F, Fi, Tw
// float2 [m, m]; outputs yre, yim float [T-1, N, m/2, m]. Returns the CUDA
// error code of the launch (0 on success); -1 for an unsupported m.
extern "C" int fused_apply_planes(const void* pre, const void* pim, const void* advance,
                                  const void* F, const void* Fi, const void* Tw, void* yre,
                                  void* yim, int T1, int N, int m, void* stream) {
  switch (m) {
    case 64:
      return fused::launch_planes<64>(pre, pim, advance, F, Fi, Tw, yre, yim, T1, N, stream);
    case 128:
      return fused::launch_planes<128>(pre, pim, advance, F, Fi, Tw, yre, yim, T1, N, stream);
    default:
      return -1;
  }
}
