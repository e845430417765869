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
// Design. What bounds them on the H100: the products, a complex m x m by
// m x m one (C2 = G Fi, 8m^3 = 16.8 MFLOP a window at m = 128) and its
// centre half (y = Fi[m/4:3m/4] B2, 8.4 MFLOP), plus the forward transform
// (33.6 MFLOP; 58.8 in all) where it is recomputed, against 64 kB (bf16
// spectrum or bf16 planes) or 32 kB (int8 window) in and 16 kB of wire
// bytes or 64 kB of float32 samples out a window: over 5,355 windows
// 0.136 ms of products at the bf16 tensor-core peak against 0.131 ms of
// bytes for the handoff (spectrum in), 0.32 ms of products against
// 0.08-0.16 ms of bytes (each block read once) where the forward is
// recomputed, so only a load that overlaps the products gets near the
// bound. The products run on the tensor cores
// (fused_common.cuh: forward_tc, then the transposed inverse
// inverse_tc_first / inverse_tc_centre, mma.sync m16n8k16 bf16 -> f32, a
// warp a 16-row strip, B2 kept in registers as the second product's A
// fragments, only the centre columns of the second product). Its epilogue
// is the int8 wire (WireChunk: quantized, staged a chunk a warp, stored 16
// bytes a lane) or the float32 samples (FloatChunk: streaming stores, each
// instruction four whole 32-byte sectors). The ramp is built per element
// from the advance (exact integer part, then the fractional part times the
// signed frequency), so no ramp table is read; sincospif of the ramp in
// turns (exact argument reduction) keeps the kernels free of a stack frame.
//   * apply_spec_kernel: a persistent grid (one CTA an SM at m = 128). Four
//     producer warps stream the next window's D (16-byte loads), multiply
//     it by the ramp and phase factor, and write G = bf16(D w) swizzled into
//     the free one of two window buffers while the m / 16 consumer warps run
//     the inverse of the other; named barriers hand the buffers over, as in
//     fourstep.cu. Shared memory at m = 128: the Fi table (64 kB), two G
//     buffers (128 kB), a 1 kB staging tile a consumer warp: 204,800 bytes.
//   * apply_i8_kernel and apply_planes_kernel: one CTA a window, m / 16
//     warps, one body (apply_window): the window's bytes (load_window_i8)
//     or planes (load_window_planes), forward_tc with F, whose epilogue
//     writes G = bf16(D w) from the float32 D over the window's buffer
//     (forward_tc's barrier between its products frees it), then the
//     inverse with Fi. The float path's weight is the ramp alone (no phase
//     factor). Shared memory at m = 128: F and Fi as separate tables (2 x
//     64 kB; Fi is not reloaded over F, which the second forward product
//     still reads) and the window / G (64 kB), 196,608 bytes, plus the
//     staging tiles (8 kB) for the wire.
// The load has no overlap with the products in the one-CTA kernels; the
// persistent grid with producer warps is the model for that.

#include "fused_common.cuh"

namespace fused {

constexpr int kProducerWarps = 4;
constexpr int kLoadUnroll = 4;  // 16-byte vector pairs (re, im) in flight a producer thread
constexpr int kFull = 1;        // named barriers kFull + s: G buffer s is written
constexpr int kEmpty = 3;       // kEmpty + s: G buffer s may be overwritten

// The persistent apply_spec_kernel: m / 16 consumer warps (a 16-row strip
// each) and the producer warps.
template <int M>
struct ApplySpecPlan {
  static constexpr int kConsumerWarps = M / 16;
  static constexpr int kConsumers = 32 * kConsumerWarps;
  static constexpr int kProducers = 32 * kProducerWarps;
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kPlane = M * M;  // bf16 elements of one plane
  // The Fi table (re, im), two G buffers (re, im), a staging tile a consumer warp.
  static constexpr size_t kBytes =
      6 * kPlane * sizeof(__nv_bfloat16) + kConsumerWarps * kWireStage;
};

// The one-CTA kernels: the F and Fi tables and the window / G, kTable bytes
// each, then the staging tiles where the epilogue is the wire.
template <int M>
struct ApplySmem {
  static constexpr size_t kTable = 2 * sizeof(__nv_bfloat16) * M * M;
  static constexpr size_t kFloatBytes = 3 * kTable;
  static constexpr size_t kWireBytes = kFloatBytes + (M / 16) * kWireStage;
};

// Ramp of natural bin k for delay d = di + df (di integer, df in [0, 1)), in
// turns: iramp(k, di) + f_k df, in [-0.5, 1.5). The explicit _rn operations
// keep the compiler from contracting it into an FMA, so it rounds as the
// plain version does.
template <int W>
__device__ __forceinline__ float ramp_turns(uint32_t k, int d_int, float df) {
  return __fadd_rn(iramp_fraction<W>(k, d_int), __fmul_rn(signed_freq<W>(k), df));
}

// The delay and phase factor of one window: the apply weight of natural bin
// k is the ramp exp(-i 2 pi turns) times p, (co - i s) (p_re + i p_im).
// sincospif(2 turns) differs from the plain version's cos / sin of fl(turns
// 2 pi) by about an ulp of the phase.
template <int M>
struct Ramp {
  int d_int;
  float df, p_re, p_im;

  __device__ __forceinline__ Ramp(float advance, float phase_re, float phase_im)
      : p_re(phase_re), p_im(phase_im) {
    const float d = -advance;
    const float di = floorf(d);
    df = d - di;
    d_int = static_cast<int>(di);
  }

  __device__ __forceinline__ float2 weight(uint32_t k) const {
    float s, co;
    sincospif(2.f * ramp_turns<M * M>(k, d_int, df), &s, &co);
    return make_float2(co * p_re + s * p_im, co * p_im - s * p_re);
  }

  // Elements (r, c) and (r, c + 1) of D, float (re, im) pairs d0, d1, times
  // their weights, rounded to bf16: the (re, im) words of G.
  __device__ __forceinline__ uint2 g_pair(int r, int c, float2 d0, float2 d1) const {
    const float2 w0 = weight(static_cast<uint32_t>(r + M * c));
    const float2 w1 = weight(static_cast<uint32_t>(r + M * (c + 1)));
    return make_uint2(tc::pack_bf16(d0.x * w0.x - d0.y * w0.y, d1.x * w1.x - d1.y * w1.y),
                      tc::pack_bf16(d0.x * w0.y + d0.y * w0.x, d1.x * w1.y + d1.y * w1.x));
  }
};

// Vector q of D (elements 8q..8q+7 of the window, row-major [k2][k1]), the
// 16-byte words vr, vi of its re / im planes, times the ramp into G: one
// 16-byte chunk of each swizzled plane gre, gim.
template <int M>
__device__ __forceinline__ void store_g(const Ramp<M>& ramp, int q, uint4 vr, uint4 vi,
                                        __nv_bfloat16* gre, __nv_bfloat16* gim) {
  const int r = 8 * q / M, c = 8 * q % M;
  const uint32_t xr[4] = {vr.x, vr.y, vr.z, vr.w};
  const uint32_t xi[4] = {vi.x, vi.y, vi.z, vi.w};
  uint32_t ore[4], oim[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 re = unpack_bf16(xr[i]), im = unpack_bf16(xi[i]);
    const uint2 gw = ramp.g_pair(r, c + 2 * i, make_float2(re.x, im.x), make_float2(re.y, im.y));
    ore[i] = gw.x;
    oim[i] = gw.y;
  }
  const int o = tc::swz<M>(r, c);
  *reinterpret_cast<uint4*>(gre + o) = make_uint4(ore[0], ore[1], ore[2], ore[3]);
  *reinterpret_cast<uint4*>(gim + o) = make_uint4(oim[0], oim[1], oim[2], oim[3]);
}

// Producer warps: window j of this CTA (window blockIdx.x + j gridDim.x of
// the batch) from dre / dim bf16 [B, m, m] into G buffer j % 2, as swizzled
// bf16 planes [k2][k1].
template <int M>
__device__ __forceinline__ void produce_g(const __nv_bfloat16* __restrict__ dre,
                                          const __nv_bfloat16* __restrict__ dim,
                                          const float* __restrict__ advance,
                                          const float* __restrict__ phase_re,
                                          const float* __restrict__ phase_im,
                                          __nv_bfloat16* win, int n_local) {
  using P = ApplySpecPlan<M>;
  constexpr int W = M * M;
  constexpr int kVec = W / 8;  // 16-byte vectors (8 elements) of a plane
  static_assert(kVec % (P::kProducers * kLoadUnroll) == 0, "whole rounds only");
  const int p = threadIdx.x - P::kConsumers;
  for (int j = 0; j < n_local; ++j) {
    const int s = j & 1;
    if (j >= 2) tc::bar_sync(kEmpty + s, P::kThreads);
    const size_t b = blockIdx.x + static_cast<size_t>(j) * gridDim.x;
    const Ramp<M> ramp(advance[b], phase_re[b], phase_im[b]);
    const uint4* src_re = reinterpret_cast<const uint4*>(dre + b * W);
    const uint4* src_im = reinterpret_cast<const uint4*>(dim + b * W);
    __nv_bfloat16* gre = win + s * 2 * P::kPlane;
    __nv_bfloat16* gim = gre + P::kPlane;
    for (int q0 = p; q0 < kVec; q0 += P::kProducers * kLoadUnroll) {
      uint4 vr[kLoadUnroll], vi[kLoadUnroll];
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u) {
        vr[u] = __ldcs(src_re + q0 + u * P::kProducers);
        vi[u] = __ldcs(src_im + q0 + u * P::kProducers);
      }
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u)
        store_g<M>(ramp, q0 + u * P::kProducers, vr[u], vi[u], gre, gim);
    }
    tc::bar_arrive(kFull + s, P::kThreads);
  }
}

// Consumer warp: the strip n1 = r0..r0+15 of the inverse of every window of
// this CTA, into the wire blocks out [B, m/2, 2m].
template <int M>
__device__ __forceinline__ void consume_g(const __nv_bfloat16* tab, const __nv_bfloat16* win,
                                          unsigned char* stage, const float2* __restrict__ Tw,
                                          int8_t* __restrict__ out, int n_local) {
  using P = ApplySpecPlan<M>;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * 16;
  unsigned char* st = stage + warp * kWireStage;
  for (int j = 0; j < n_local; ++j) {
    const int s = j & 1;
    const size_t b = blockIdx.x + static_cast<size_t>(j) * gridDim.x;
    tc::bar_sync(kFull + s, P::kThreads);
    uint32_t cre[M / 16][4], cim[M / 16][4];
    inverse_tc_first<M>(tab, win + s * 2 * P::kPlane, Tw, r0, cre, cim);
    // G is consumed: the producers may refill its buffer.
    if (j + 2 < n_local) tc::bar_arrive(kEmpty + s, P::kThreads);
    WireChunk<M> epi{st, r0, out + b * (M * M)};
    inverse_tc_centre<M>(cre, cim, tab, epi);
  }
}

// The spectrum handoff: dre, dim bf16 [B, m, m] (B = (T-1) N windows, the
// permuted D of fused_measure_i8_spec); advance, phase_re, phase_im float
// [B]; writes int8 wire blocks out [B, m/2, 2m]. CTA b handles windows b,
// b + gridDim.x, ...
template <int M>
__global__ void __launch_bounds__(ApplySpecPlan<M>::kThreads, 1)
apply_spec_kernel(const __nv_bfloat16* __restrict__ dre, const __nv_bfloat16* __restrict__ dim,
                  const float* __restrict__ advance, const float* __restrict__ phase_re,
                  const float* __restrict__ phase_im, const float2* __restrict__ Fi,
                  const float2* __restrict__ Tw, int8_t* __restrict__ out, int B) {
  using P = ApplySpecPlan<M>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* win = tab + 2 * P::kPlane;
  unsigned char* stage = reinterpret_cast<unsigned char*>(win + 4 * P::kPlane);

  load_table<M, P::kThreads>(Fi, tab);
  __syncthreads();

  const int grid = static_cast<int>(gridDim.x);
  const int n_local = (B - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  if (threadIdx.x >= P::kConsumers)
    produce_g<M>(dre, dim, advance, phase_re, phase_im, win, n_local);
  else
    consume_g<M>(tab, win, stage, Tw, out, n_local);
}

// The one-CTA body of the recompute applies: load(w) fills the window's
// swizzled planes at w; after the load, make_ramp() gives the window's
// Ramp, and G = bf16(D w) is formed from the float32 D of forward_tc; the
// inverse's centre chunks of warp w's strip go to the epilogue epi_of(st,
// w), st the staging tiles (where the wire epilogue has them).
template <int M, class Load, class MakeRamp, class EpiOf>
__device__ __forceinline__ void apply_window(const float2* __restrict__ F,
                                             const float2* __restrict__ Fi,
                                             const float2* __restrict__ Tw, Load load,
                                             MakeRamp make_ramp, EpiOf epi_of) {
  constexpr int W = M * M;
  using S = ApplySmem<M>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tab_f = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* tab_fi = reinterpret_cast<__nv_bfloat16*>(smem + S::kTable);
  __nv_bfloat16* win_s = reinterpret_cast<__nv_bfloat16*>(smem + 2 * S::kTable);

  load_table<M>(F, tab_f);
  load_table<M>(Fi, tab_fi);
  load(win_s);
  __syncthreads();

  // G = bf16(D w) from the float32 D, not a bf16-rounded one, over the
  // window's buffer: forward_tc's barrier between its products parts the
  // last read of the window from the first write of G.
  const Ramp<M> ramp = make_ramp();
  forward_tc<M>(tab_f, win_s, Tw, [&](int r, int c, float4 d) {
    const uint2 gw = ramp.g_pair(r, c, make_float2(d.x, d.y), make_float2(d.z, d.w));
    const int o = tc::swz<M>(r, c);
    *reinterpret_cast<uint32_t*>(win_s + o) = gw.x;
    *reinterpret_cast<uint32_t*>(win_s + W + o) = gw.y;
  });
  __syncthreads();  // G complete

  const int warp = threadIdx.x >> 5;
  uint32_t cre[M / 16][4], cim[M / 16][4];
  inverse_tc_first<M>(tab_fi, win_s, Tw, warp * 16, cre, cim);
  auto epi = epi_of(smem + S::kFloatBytes, warp);
  inverse_tc_centre<M>(cre, cim, tab_fi, epi);
}

// The recompute path: int8 blocks raw [T, N, m/2, 2m] and advance, phase_re,
// phase_im float [T-1, N]; writes int8 wire blocks out [T-1, N, m/2, 2m].
// One CTA per (t, n) = (blockIdx.y, blockIdx.x).
template <int M>
__global__ void __launch_bounds__(kTcThreads<M>)
apply_i8_kernel(const int8_t* __restrict__ raw, const float* __restrict__ advance,
                const float* __restrict__ phase_re, const float* __restrict__ phase_im,
                const float2* __restrict__ F, const float2* __restrict__ Fi,
                const float2* __restrict__ Tw, int8_t* __restrict__ out) {
  constexpr int W = M * M;
  const int n = blockIdx.x;
  const int N = gridDim.x;
  const int t = blockIdx.y;
  const size_t win = static_cast<size_t>(t) * N + n;
  apply_window<M>(
      F, Fi, Tw,
      [&](__nv_bfloat16* w) { load_window_i8<M>(raw + win * W, static_cast<size_t>(N) * W, w); },
      [&] { return Ramp<M>(advance[win], phase_re[win], phase_im[win]); },
      [&](unsigned char* stage, int warp) {
        return WireChunk<M>{stage + warp * kWireStage, warp * 16, out + win * W};
      });
}

// The float path: block planes pre/pim bf16 [T, N, m/2, m] and advance
// float [T-1, N]; writes the centre half yre, yim float [T-1, N, m/2, m]
// (row n2 - m/4 of a window holds samples n1). One CTA per (t, n) =
// (blockIdx.y, blockIdx.x).
template <int M>
__global__ void __launch_bounds__(kTcThreads<M>)
apply_planes_kernel(const __nv_bfloat16* __restrict__ pre, const __nv_bfloat16* __restrict__ pim,
                    const float* __restrict__ advance, const float2* __restrict__ F,
                    const float2* __restrict__ Fi, const float2* __restrict__ Tw,
                    float* __restrict__ yre_out, float* __restrict__ yim_out) {
  constexpr int W = M * M;
  const int n = blockIdx.x;
  const int N = gridDim.x;
  const int t = blockIdx.y;
  const size_t win = static_cast<size_t>(t) * N + n;
  const size_t top = win * (W / 2);  // block t of channel n; also the window's output
  apply_window<M>(
      F, Fi, Tw,
      [&](__nv_bfloat16* w) {
        load_window_planes<M>(pre + top, pim + top, static_cast<size_t>(N) * (W / 2), w);
      },
      [&] { return Ramp<M>(advance[win], 1.f, 0.f); },
      [&](unsigned char*, int warp) {
        return FloatChunk<M>{warp * 16, yre_out + top, yim_out + top};
      });
}

template <int M>
int launch(const void* dre, const void* dim, const void* advance, const void* phase_re,
           const void* phase_im, const void* Fi, const void* Tw, void* out, int T1, int N,
           void* stream) {
  using P = ApplySpecPlan<M>;
  static int capacity[tc::kMaxDevices];  // the persistent grid's occupancy, a device
  const int B = T1 * N;
  const int grid = tc::persistent_grid(apply_spec_kernel<M>, P::kThreads,
                                       static_cast<int>(P::kBytes), B, capacity);
  if (grid < 0) return -grid;
  apply_spec_kernel<M><<<grid, P::kThreads, P::kBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dre), static_cast<const __nv_bfloat16*>(dim),
      static_cast<const float*>(advance), static_cast<const float*>(phase_re),
      static_cast<const float*>(phase_im), static_cast<const float2*>(Fi),
      static_cast<const float2*>(Tw), static_cast<int8_t*>(out), B);
  return cudaGetLastError();
}

template <int M>
int launch_i8(const void* raw, const void* advance, const void* phase_re, const void* phase_im,
              const void* F, const void* Fi, const void* Tw, void* out, int T1, int N,
              void* stream) {
  const int smem = static_cast<int>(ApplySmem<M>::kWireBytes);
  const cudaError_t err = set_smem(apply_i8_kernel<M>, smem);
  if (err != cudaSuccess) return err;
  apply_i8_kernel<M><<<dim3(N, T1), kTcThreads<M>, smem, static_cast<cudaStream_t>(stream)>>>(
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
  const int smem = static_cast<int>(ApplySmem<M>::kFloatBytes);
  const cudaError_t err = set_smem(apply_planes_kernel<M>, smem);
  if (err != cudaSuccess) return err;
  apply_planes_kernel<M>
      <<<dim3(N, T1), kTcThreads<M>, smem, static_cast<cudaStream_t>(stream)>>>(
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
// success); -1 for an unsupported m or no window.
extern "C" int fused_apply_spec_i8(const void* dre, const void* dim, const void* advance,
                                   const void* phase_re, const void* phase_im, const void* Fi,
                                   const void* Tw, void* out, int T1, int N, int m,
                                   void* stream) {
  if (T1 < 1 || N < 1) return -1;
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
