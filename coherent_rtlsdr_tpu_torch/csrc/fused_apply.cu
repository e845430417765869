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
// bound. The one-CTA kernels run their products on mma.sync
// (fused_common.cuh: forward_tc, then the transposed inverse
// inverse_tc_first / inverse_tc_centre, m16n8k16 bf16 -> f32, a warp a
// 16-row strip, B2 kept in registers as the second product's A fragments,
// only the centre columns of the second product), the persistent handoff
// kernel the same inverse on wgmma. The epilogue is the int8 wire
// (WireChunk: quantized, staged a chunk a warp, stored 16 bytes a lane) or
// the float32 samples (FloatChunk: streaming stores, each instruction four
// whole 32-byte sectors). The one-CTA and m = 256 kernels build the ramp
// per element (Ramp::weight: exact integer part, then the fractional part
// times the signed frequency, one sincospif of the ramp in turns, whose
// exact argument reduction keeps them free of a stack frame): no cell runs
// the one-CTA ones, and the phasors at m = 256 are work for a change
// measured on b32768.offline, which the persistent kernel's change leaves
// untouched.
//   * apply_spec_kernel (m = 64, 128): a persistent grid, min(windows, CTAs
//     that fit: one an SM at m = 128) CTAs, CTA b taking windows b, b +
//     grid, ... on a fixed stride (no work counter, so a captured CUDA
//     graph replays it). An offline call of T = 256 is ~41 windows a CTA,
//     a server block of 21 windows one. Two warpgroups of consumers (one at
//     m = 64) and one of ramp warps; at m = 128 the ramp warpgroup gives up
//     registers to the consumers (setmaxnreg: 40 and 232 a thread). A
//     window's path, two windows in flight a CTA:
//       - the copy engine brings window j + 2's D (two bf16 planes, 32 kB
//         each at m = 128) into buffer j % 2 by cp.async.bulk, issued by
//         one thread and completing on the buffer's mbarrier, once window
//         j's first product has read that buffer;
//       - the ramp warps turn D into G = bf16(D row[r] col[c]) in place,
//         from 2m phasors a window (ramp_phasors: the ramp of bin r + m c
//         is a row phasor times a signed-column phasor, the phase factor
//         folded into the rows) instead of one sincospif an element, and
//         write G in the tiled layout the first product reads (ramp_window:
//         an 8-row band is the same 2 kB in both layouts);
//       - the consumers run C2^T = Fi G^T on wgmma m64n32k16 (Fi's A
//         fragments held in registers for every window, G the K-major B
//         through descriptors), B2^T = bf16(C2^T conj(T)) into registers
//         (the twiddle read from L2 after each chunk's product), then y^T =
//         B2^T Fi on the centre columns (Fi's tiled planes the K-major B),
//         into the wire; window j + 1's ramp runs beside window j's
//         products.
//     The consumers' registers set the design: Fi's fragments (64 a
//     thread), B2's (64) and a chunk's accumulators (32) leave no room for
//     the twiddle read ahead of the product (32 more spilled), so the ramp
//     warpgroup runs on 40 registers (one 16-byte chunk a plane a thread)
//     and hands the consumers 232.
//     What bounds it: 25.2 MFLOP of products a window at m = 128, 3.4 us on
//     one SM's share of the bf16 peak, and 80 kB of bytes (64 in, 16 out),
//     3.1 us of an SM's share of 3.35 TB/s. Shared memory at m = 128, 208,912
//     of the 232,448 bytes a CTA may have (ApplySpecPlan): Fi's tiled planes
//     (64 kB), two window buffers (2 x 64 kB, each D then G), a 1 kB
//     staging tile a consumer warp, two phasor tables (2 x 2 kB) and the two
//     buffers' mbarriers. A separate D slot beside two G buffers would need
//     264 kB. Measured (H100, 700 W, T = 256, N = 21; PERF.md section 6,
//     row 2): 0.30 ms a call against 0.59 for producer warps that took a
//     sincospif an element and consumers on mma.sync; 0.20 ms with the
//     products cut out: the copies, the ramp and the wire epilogue overlap
//     the products only in part.
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
// persistent grid is the model for that.
//
// m = 256 (W = 65536): every apply runs a window on a cluster of four CTAs
// of four warpgroups (fused_cluster.cuh), the inverse (inverse_cluster) the
// mirror of the measure's forward: CTA p holds row block p of G, computes
// row block p of B2 = bf16((G Fi) * conj(T)), and after a cluster exchange
// the centre rows of y = Fi B2 on strip p (y^T = B2^T Fi, each warpgroup
// 32 of the 128 rows), 128 bytes of each wire row (or 64 float32 samples
// of each output row). G's row block comes from the stored D
// (apply_spec_cluster_kernel) or from the forward transform recomputed on
// the cluster (forward_cluster over StripI8 or StripPlanes;
// apply_i8_cluster_kernel, apply_planes_cluster_kernel), whose epilogue
// weights the float32 D into G over Y: once forward_cluster's last
// barrier has passed, no other CTA reads Y. F and Fi stream through the
// table ring (the recompute applies' ring runs F's 32 slices, then Fi's),
// the products on wgmma. Shared memory 196,688 bytes: two buffers of 64
// kB, one holding G and then the gathered strip of B2, the other the
// forward's window strip and C's row block, then B2's row block, which
// the other CTAs gather; the ring's four 16 kB slots and its barriers.

#include "fused_cluster.cuh"
#include "fused_common.cuh"

namespace fused {

// The persistent apply_spec_kernel at m in {64, 128}: m / 16 consumer warps
// (m / 64 warpgroups on wgmma, a 16-row strip a warp) and a warpgroup of
// ramp warps that turn each window's D into G in place. At m = 128 the
// three warpgroups (12 warps, three a sub-partition, launched at 168
// registers a thread) split a sub-partition's registers as kRampRegs + 2
// kConsumerRegs = 3 x 168 (tc::setmaxnreg_*: more, and the consumers'
// request would wait for ever); at m = 64 two warpgroups leave each warp
// 255.
constexpr int kRampWarps = 4;
constexpr int kRampRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kFull = 1;       // named barriers kFull + s: buffer s holds G
constexpr int kConsumed = 3;   // the consumers: their first product has read G
constexpr int kRampSync = 4;   // the ramp warps: phasors written, or bands read

template <int M>
struct ApplySpecPlan {
  static constexpr int kConsumerWarps = M / 16;
  static constexpr int kConsumers = 32 * kConsumerWarps;
  static constexpr int kRamps = 32 * kRampWarps;
  static constexpr int kThreads = kConsumers + kRamps;
  // Bytes of a window's bf16 re / im planes: the Fi table, or a buffer.
  static constexpr size_t kPlanes = 2 * sizeof(__nv_bfloat16) * M * M;
  // Fi's tiled planes at 0; buffers 0 and 1 at kPlanes and 2 kPlanes; a
  // staging tile a consumer warp; two phasor tables (m row phasors, then m
  // column phasors, float2, in ramp_window's order); a barrier a buffer.
  static constexpr size_t kStage = 3 * kPlanes;
  static constexpr size_t kPhasors = kStage + kConsumerWarps * kWireStage;
  static constexpr size_t kBars = kPhasors + 2 * 2 * M * sizeof(float2);
  static constexpr size_t kBytes = kBars + 2 * sizeof(uint64_t);
  static_assert(kBytes <= 232448, "a CTA's shared memory on the H100");
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

// Window b's D planes (bf16 [m, m] each, row-major [k2][k1]) into the
// buffer `buf` (re, then im) by the copy engine, by one thread: the
// buffer's barrier armed with both copies' bytes.
template <int M>
__device__ __forceinline__ void stage_spectrum(const __nv_bfloat16* __restrict__ dre,
                                               const __nv_bfloat16* __restrict__ dim, size_t b,
                                               __nv_bfloat16* buf, uint64_t* bar) {
  constexpr uint32_t kPlane = sizeof(__nv_bfloat16) * M * M;
  cl::mbar_arm(bar, 2 * kPlane);
  bulk_load(buf, dre + b * M * M, kPlane, bar);
  bulk_load(buf + M * M, dim + b * M * M, kPlane, bar);
}

// The window's ramp as a row phasor times a column phasor. For bin k = r +
// m c (row r = k2, column c = k1) and delay d = di + df, the ramp
// e^{-2 pi i (k di / W + f_k df)} is e^{-2 pi i (r di / W + r df / W)}
// times e^{-2 pi i (c di / m + c_s df / m)}, c_s the signed column (c - m
// from c = m/2 on, where k >= W/2 and f_k = (k - W) / W): the integer part
// from exact residues, as iramp_fraction gives them. The ramp threads (p of
// kRamps) write table `ph` for the window's delay and phase factor `w`: the
// m row phasors times the phase factor, then the m column phasors (at
// col_slot); each is (cos, -sin) of 2 pi turns by sincospif, one a table
// entry (tests/test_torch_apply_ramp.py holds the split to the plain
// version's ramp).
template <int M>
__device__ __forceinline__ int col_slot(int c) {
  // Columns 8 c8 + 2v, 8 c8 + 2v + 1 are the float4 at v (m / 8) + c8: the
  // 8 lanes of a quarter warp in ramp_window, whose c8 differ mod 8, read
  // 8 distinct bank groups.
  return 2 * ((c % 8 / 2) * (M / 8) + c / 8) + c % 2;
}

template <int M>
__device__ __forceinline__ void ramp_phasors(const Ramp<M>& w, float2* ph, int p) {
  constexpr int W = M * M;
  for (int i = p; i < 2 * M; i += kRampWarps * 32) {
    const bool row = i < M;
    const uint32_t x = static_cast<uint32_t>(row ? i : i - M);
    const int xs = row || x < M / 2 ? static_cast<int>(x) : static_cast<int>(x) - M;
    const float turns = row ? __fadd_rn(iramp_fraction<W>(x, w.d_int),
                                        __fmul_rn(static_cast<float>(xs) * (1.f / W), w.df))
                            : __fadd_rn(iramp_fraction<M>(x, w.d_int),
                                        __fmul_rn(static_cast<float>(xs) * (1.f / M), w.df));
    float s, co;
    sincospif(2.f * turns, &s, &co);
    if (row)
      ph[i] = make_float2(co * w.p_re + s * w.p_im, co * w.p_im - s * w.p_re);
    else
      ph[M + col_slot<M>(static_cast<int>(x))] = make_float2(co, -s);
  }
}

// The ramp warpgroup's pass over a window, in place: the buffer `buf` holds
// D as row-major bf16 planes (re, im) and ends holding G = bf16(D row[r]
// col[c]) as tiled planes (fused_common.cuh: tiled), the layout the
// inverse's first product reads. An 8-row band (rows 8R..8R+7) fills the
// same 2 kB of a plane in both layouts, so the ramp threads take 128 / m
// bands at a time, one 16-byte chunk of each plane a thread, and read all
// of them (a barrier of the ramp threads) before they write any: four
// registers of D a plane a thread, which keeps the warpgroup within the
// few registers it leaves to the consumers. Thread p takes row 8R + i (i =
// p % 8) and column chunk c8 = (p % m / 8 + i) mod (m / 8); the 8 threads
// of a quarter warp then read 8 distinct bank groups (c8 mod 8: the D
// chunk and the column phasors at col_slot) and write 8 (i).
template <int M>
__device__ __forceinline__ void ramp_window(__nv_bfloat16* buf, const float2* ph, int p) {
  constexpr int kRow = M / 8;              // 16-byte chunks in a row of a plane
  constexpr int kBands = kRampWarps * 32 / M;   // bands a step
  const int i = p & 7;
  const int c8 = ((p % M) / 8 + i) % kRow;
  const float4* col = reinterpret_cast<const float4*>(ph + M);
  uint4* re = reinterpret_cast<uint4*>(buf);
  uint4* im = reinterpret_cast<uint4*>(buf + M * M);
#pragma unroll 1
  for (int band = p / M; band < M / 8; band += kBands) {
    const int r = 8 * band + i;
    const uint4 vr = re[r * kRow + c8], vi = im[r * kRow + c8];
    tc::bar_sync(kRampSync, kRampWarps * 32);   // the bands are read: G may overwrite them
    const float2 rw = ph[r];
    const uint32_t xr[4] = {vr.x, vr.y, vr.z, vr.w};
    const uint32_t xi[4] = {vi.x, vi.y, vi.z, vi.w};
    uint32_t ore[4], oim[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // Columns 8 c8 + 2e and 8 c8 + 2e + 1: the weight row[r] col[c], then D w.
      const float2 dr = unpack_bf16(xr[e]), di = unpack_bf16(xi[e]);
      const float4 c = col[e * kRow + c8];
      const float w0r = rw.x * c.x - rw.y * c.y, w0i = rw.x * c.y + rw.y * c.x;
      const float w1r = rw.x * c.z - rw.y * c.w, w1i = rw.x * c.w + rw.y * c.z;
      ore[e] = tc::pack_bf16(dr.x * w0r - di.x * w0i, dr.y * w1r - di.y * w1i);
      oim[e] = tc::pack_bf16(dr.x * w0i + di.x * w0r, dr.y * w1i + di.y * w1r);
    }
    const int o = tiled<M>(r, 8 * c8) / 8;
    re[o] = make_uint4(ore[0], ore[1], ore[2], ore[3]);
    im[o] = make_uint4(oim[0], oim[1], oim[2], oim[3]);
  }
}

// The ramp warps: window j of this CTA (window blockIdx.x + j gridDim.x of
// the batch) waits in buffer j % 2 for its D, which they turn into G there
// (ramp_window) with the phasors of table j % 2, then hand to the
// consumers.
template <int M>
__device__ __forceinline__ void ramp_windows(const float* __restrict__ advance,
                                             const float* __restrict__ phase_re,
                                             const float* __restrict__ phase_im,
                                             unsigned char* smem, uint64_t* bars, int n_local) {
  using P = ApplySpecPlan<M>;
  const int p = threadIdx.x - P::kConsumers;
  for (int j = 0; j < n_local; ++j) {
    const int s = j & 1;
    const size_t b = blockIdx.x + static_cast<size_t>(j) * gridDim.x;
    float2* ph = reinterpret_cast<float2*>(smem + P::kPhasors) + s * 2 * M;
    // Table s was last read for window j - 2, before every ramp thread
    // passed window j - 1's first barrier below.
    ramp_phasors<M>(Ramp<M>(advance[b], phase_re[b], phase_im[b]), ph, p);
    tc::bar_sync(kRampSync, P::kRamps);
    cl::mbar_wait(bars + s, (j >> 1) & 1);
    ramp_window<M>(reinterpret_cast<__nv_bfloat16*>(smem + (1 + s) * P::kPlanes), ph, p);
    fence_for_wgmma();
    tc::bar_arrive(kFull + s, P::kThreads);
  }
}

// acc = Fi G^T over this warpgroup's 64 rows n1 (this warp's 16, r0..r0+15:
// Fi's A fragments fr, fi, every k step) and chunk cc's kChunk columns k2,
// on wgmma with G (tiled planes [k2][k1]) as the K-major B: re = Fr Gr -
// Fi Gi, im = Fr Gi + Fi Gr, four m64n32k16 products a k step, all waited
// for before it returns. A k step is 2 tiles (256 bytes) on in a row of
// tiles, so one descriptor a plane walks them (tc::desc_advance).
template <int M>
__device__ __forceinline__ void inverse_first(const uint32_t (&fr)[M / 16][4],
                                              const uint32_t (&fi)[M / 16][4],
                                              const __nv_bfloat16* gre,
                                              const __nv_bfloat16* gim, int cc,
                                              float (&are)[tc::kChunkTiles][4],
                                              float (&aim)[tc::kChunkTiles][4]) {
  static_assert(tc::kChunk == 32, "m64n32k16");
#pragma unroll
  for (int i = 0; i < tc::kChunkTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) are[i][e] = aim[i][e] = 0.f;
  const int o = tiled<M>(cc * tc::kChunk, 0);
  uint64_t bre = tc::desc_k(gre + o, 128, (M / 8) * 128);
  uint64_t bim = tc::desc_k(gim + o, 128, (M / 8) * 128);
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < M / 16; ++ks) {
    tc::wgmma<32, 1>(are, fr[ks], bre);
    tc::wgmma<32, -1>(are, fi[ks], bim);
    tc::wgmma<32, 1>(aim, fr[ks], bim);
    tc::wgmma<32, 1>(aim, fi[ks], bre);
    tc::desc_advance<256>(bre);
    tc::desc_advance<256>(bim);
  }
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
}

// acc = B2^T Fi over this warpgroup's 64 rows n1 (this warp's 16: B2^T's A
// fragments cre, cim) and the kChunk columns n2 from n0, on wgmma with Fi's
// tiled planes (symmetric) as the K-major B: re = Cr Fr - Ci Fi, im = Cr Fi
// + Ci Fr, all waited for before it returns; one descriptor a plane, as in
// inverse_first.
template <int M>
__device__ __forceinline__ void inverse_second(const uint32_t (&cre)[M / 16][4],
                                               const uint32_t (&cim)[M / 16][4],
                                               const __nv_bfloat16* fre,
                                               const __nv_bfloat16* fim, int n0,
                                               float (&yre)[tc::kChunkTiles][4],
                                               float (&yim)[tc::kChunkTiles][4]) {
#pragma unroll
  for (int i = 0; i < tc::kChunkTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) yre[i][e] = yim[i][e] = 0.f;
  const int o = tiled<M>(n0, 0);
  uint64_t bre = tc::desc_k(fre + o, 128, (M / 8) * 128);
  uint64_t bim = tc::desc_k(fim + o, 128, (M / 8) * 128);
  tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < M / 16; ++kk) {
    tc::wgmma<32, 1>(yre, cre[kk], bre);
    tc::wgmma<32, -1>(yre, cim[kk], bim);
    tc::wgmma<32, 1>(yim, cre[kk], bim);
    tc::wgmma<32, 1>(yim, cim[kk], bre);
    tc::desc_advance<256>(bre);
    tc::desc_advance<256>(bim);
  }
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
}

// The consumer warps: the strip n1 = r0..r0+15 of the inverse of every
// window of this CTA, into the wire blocks out [B, m/2, 2m]. Once every
// first product of window j has read buffer j % 2, thread 0 sends the copy
// engine window j + 2's D into it.
template <int M>
__device__ __forceinline__ void consume_windows(const __nv_bfloat16* __restrict__ dre,
                                                const __nv_bfloat16* __restrict__ dim,
                                                const float2* __restrict__ Tw,
                                                int8_t* __restrict__ out, unsigned char* smem,
                                                uint64_t* bars, int n_local) {
  using P = ApplySpecPlan<M>;
  constexpr int W = M * M;
  const __nv_bfloat16* tab = reinterpret_cast<const __nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * 16;
  unsigned char* st = smem + P::kStage + warp * kWireStage;
  // Fi's A fragments of the strip (rows r0..r0+15, every k step), held for
  // every window: the first product's A is the same each time.
  uint32_t fr[M / 16][4], fi[M / 16][4];
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < M / 16; ++ks) {
    const int o = tiled<M>(r0 + (l & 15), ks * 16 + (l >> 4) * 8);   // tc::ldsm_a's lanes
    tc::ldsm_x4(tc::smem_addr(tab + o), fr[ks]);
    tc::ldsm_x4(tc::smem_addr(tab + W + o), fi[ks]);
  }
  for (int j = 0; j < n_local; ++j) {
    const int s = j & 1;
    const size_t b = blockIdx.x + static_cast<size_t>(j) * gridDim.x;
    __nv_bfloat16* g = reinterpret_cast<__nv_bfloat16*>(smem + (1 + s) * P::kPlanes);
    tc::bar_sync(kFull + s, P::kThreads);
    // C2^T = Fi G^T, then B2^T = bf16(C2^T * conj(T)) as the second
    // product's A, the twiddle read from L2 after each chunk's product. The
    // twiddle's and the wire's lane addresses are made where they are used
    // (tc::lane_id): hoisted out of the loop they held registers through
    // the first product and spilled.
    uint32_t cre[M / 16][4], cim[M / 16][4];
#pragma unroll
    for (int cc = 0; cc < M / tc::kChunk; ++cc) {
      float are[tc::kChunkTiles][4], aim[tc::kChunkTiles][4];
      inverse_first<M>(fr, fi, g, g + W, cc, are, aim);
      tc::twiddle_to_a<M, true>(are, aim, Tw, r0, cc, cre, cim, tc::lane_id());
    }
    tc::bar_sync(kConsumed, P::kConsumers);
    if (threadIdx.x == 0 && j + 2 < n_local) {
      fence_for_wgmma();   // after the ramp warps' stores to the buffer, before the copy's
      stage_spectrum<M>(dre, dim, b + 2 * static_cast<size_t>(gridDim.x), g, bars + s);
    }
    // y^T = B2^T Fi on the centre columns n2 in [m/4, 3m/4), to the wire.
    WireChunk<M> epi{st, r0, out + b * W, tc::lane_id()};
#pragma unroll 1
    for (int n0 = M / 4; n0 < 3 * M / 4; n0 += tc::kChunk) {
      float yre[tc::kChunkTiles][4], yim[tc::kChunkTiles][4];
      inverse_second<M>(cre, cim, tab, tab + W, n0, yre, yim);
      epi(n0, yre, yim);
    }
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
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::kBars);
  const int grid = static_cast<int>(gridDim.x);
  const int n_local = (B - static_cast<int>(blockIdx.x) + grid - 1) / grid;

  if (threadIdx.x == 0) {
    cl::mbar_init(bars, 1);
    cl::mbar_init(bars + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_table<M, P::kThreads, true>(Fi, reinterpret_cast<__nv_bfloat16*>(smem));
  fence_for_wgmma();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int j = 0; j < 2 && j < n_local; ++j)
      stage_spectrum<M>(dre, dim, blockIdx.x + static_cast<size_t>(j) * grid,
                        reinterpret_cast<__nv_bfloat16*>(smem + (1 + j) * P::kPlanes), bars + j);
  if (threadIdx.x >= P::kConsumers) {
    if constexpr (M == 128) tc::setmaxnreg_dec<kRampRegs>();
    ramp_windows<M>(advance, phase_re, phase_im, smem, bars, n_local);
  } else {
    if constexpr (M == 128) tc::setmaxnreg_inc<kConsumerRegs>();
    consume_windows<M>(dre, dim, Tw, out, smem, bars, n_local);
  }
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
        return WireChunk<M>{stage + warp * kWireStage, warp * 16, out + win * W,
                            static_cast<int>(threadIdx.x & 31)};
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

// --- m = 256: a window a cluster of four CTAs (fused_cluster.cuh).

// Shared memory of the m = 256 applies: X, Y (kBuf each), the table ring.
struct ApplyClusterSmem {
  static constexpr size_t kX = 0, kY = cl::kBuf, kRing = 2 * cl::kBuf;
  static constexpr size_t kBars = kRing + cl::kRingBytes;
  static constexpr size_t kBytes = kBars + cl::kRingBarBytes;
};

// The wire epilogue of the m = 256 applies: output row n2 (in [m/4, 3m/4)),
// columns c, c + 1 of strip p quantized to two wire pairs of the window's
// block [m/2, 2m].
struct ClusterWire {
  int8_t* wire;
  int p;

  __device__ __forceinline__ void operator()(int r, int c, float4 y) const {
    const uint32_t w = wire_pair(y.x, y.y) | (static_cast<uint32_t>(wire_pair(y.z, y.w)) << 16);
    __stcs(reinterpret_cast<unsigned int*>(wire + (r - cl::kM / 4) * (2 * cl::kM) +
                                           2 * (cl::kPart * p + c)),
           w);
  }
};

// The float epilogue of the m = 256 apply: samples (n2 - m/4) m + n1 of the
// window's planes yre, yim [m/2, m], n1 = 64 p + c, c + 1.
struct ClusterFloat {
  float* yre;
  float* yim;
  int p;

  __device__ __forceinline__ void operator()(int r, int c, float4 y) const {
    const int o = (r - cl::kM / 4) * cl::kM + cl::kPart * p + c;
    __stcs(reinterpret_cast<float2*>(yre + o), make_float2(y.x, y.z));
    __stcs(reinterpret_cast<float2*>(yim + o), make_float2(y.y, y.w));
  }
};

// The spectrum handoff at m = 256: the cluster of window b = blockIdx.x / 4
// of dre, dim bf16 [B, m, m] (advance, phase_re, phase_im float [B]) writes
// the wire block out[b] [m/2, 2m]. CTA rank p: row block p of G = bf16(D w)
// (k2 in [64 p, 64 p + 64)) into X, then inverse_cluster's centre rows.
__global__ void __cluster_dims__(cl::kRanks, 1, 1) __launch_bounds__(cl::kThreads, 1)
apply_spec_cluster_kernel(const __nv_bfloat16* __restrict__ dre,
                          const __nv_bfloat16* __restrict__ dim,
                          const float* __restrict__ advance, const float* __restrict__ phase_re,
                          const float* __restrict__ phase_im,
                          const __nv_bfloat16* __restrict__ Fi, const float2* __restrict__ Tw,
                          int8_t* __restrict__ out) {
  using namespace cl;
  using S = ApplyClusterSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(smem + S::kX);
  __nv_bfloat16* Y = reinterpret_cast<__nv_bfloat16*>(smem + S::kY);
  using TabRing = Ring<S::kRing, S::kBars, 1>;
  TabRing::start(Fi, Fi);
  const int p = TabRing::rank();
  const size_t b = blockIdx.x / kRanks;

  // Row block p of G: 16-byte vectors of D (8 elements of a row), weighted.
  {
    const Ramp<kM> ramp(advance[b], phase_re[b], phase_im[b]);
    constexpr int kVec = kPlane / 8;
    constexpr int kSteps = kVec / kThreads;
    static_assert(kVec % kThreads == 0, "whole rounds only");
    const uint4* src_re = reinterpret_cast<const uint4*>(dre + b * kW) + p * kVec;
    const uint4* src_im = reinterpret_cast<const uint4*>(dim + b * kW) + p * kVec;
    uint4 vr[kSteps], vi[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      vr[u] = __ldcs(src_re + threadIdx.x + u * kThreads);
      vi[u] = __ldcs(src_im + threadIdx.x + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int q = threadIdx.x + u * kThreads;
      const int r = 8 * q / kM, c = 8 * q % kM;
      const uint32_t xr[4] = {vr[u].x, vr[u].y, vr[u].z, vr[u].w};
      const uint32_t xi[4] = {vi[u].x, vi[u].y, vi[u].z, vi[u].w};
      uint32_t ore[4], oim[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 re = unpack_bf16(xr[i]), im = unpack_bf16(xi[i]);
        const uint2 gw = ramp.g_pair(kPart * p + r, c + 2 * i, make_float2(re.x, im.x),
                                     make_float2(re.y, im.y));
        ore[i] = gw.x;
        oim[i] = gw.y;
      }
      const int o = tc::swz<kM>(r, c);
      *reinterpret_cast<uint4*>(X + o) = make_uint4(ore[0], ore[1], ore[2], ore[3]);
      *reinterpret_cast<uint4*>(X + kPlane + o) = make_uint4(oim[0], oim[1], oim[2], oim[3]);
    }
  }
  __syncthreads();
  inverse_cluster<TabRing, kM / 4, kM / 2>(0, Tw, X, Y, ClusterWire{out + b * kW, p});
}

// The m = 256 recompute body: forward_cluster over the window's strip
// loader `load`, its epilogue writing row block p of G = bf16(D w) from the
// float32 D into Y (ramp: the window's Ramp), then inverse_cluster's
// centre rows to `epi`; PIPE as in fused_cluster.cuh's ring_product.
template <bool PIPE, class Load, class Epi>
__device__ __forceinline__ void apply_cluster_window(const Load& load, const Ramp<cl::kM>& ramp,
                                                     const __nv_bfloat16* __restrict__ F,
                                                     const __nv_bfloat16* __restrict__ Fi,
                                                     const float2* __restrict__ Tw,
                                                     const Epi& epi) {
  using namespace cl;
  using S = ApplyClusterSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(smem + S::kX);
  __nv_bfloat16* Y = reinterpret_cast<__nv_bfloat16*>(smem + S::kY);
  using TabRing = Ring<S::kRing, S::kBars, 2>;
  TabRing::start(F, Fi);
  const int p = TabRing::rank();
  forward_cluster<TabRing, PIPE>(load, 0, Tw, X, Y, [&](int r, int c, float4 d) {
    const uint2 gw = ramp.g_pair(kPart * p + r, c, make_float2(d.x, d.y), make_float2(d.z, d.w));
    const int o = tc::swz<kM>(r, c);
    *reinterpret_cast<uint32_t*>(Y + o) = gw.x;
    *reinterpret_cast<uint32_t*>(Y + kPlane + o) = gw.y;
  });
  __syncthreads();   // G complete; C's row block in X read
  inverse_cluster<TabRing, kM / 4, kM / 2, PIPE>(2 * kSlices, Tw, Y, X, epi);
}

// The recompute path at m = 256: the cluster of window b = blockIdx.x / 4
// (b = t N + n) of the int8 blocks raw [T, N, m/2, 2m], with advance,
// phase_re, phase_im float [T-1, N], writes the wire block out[b].
__global__ void __cluster_dims__(cl::kRanks, 1, 1) __launch_bounds__(cl::kThreads, 1)
apply_i8_cluster_kernel(const int8_t* __restrict__ raw, const float* __restrict__ advance,
                        const float* __restrict__ phase_re, const float* __restrict__ phase_im,
                        const __nv_bfloat16* __restrict__ F, const __nv_bfloat16* __restrict__ Fi,
                        const float2* __restrict__ Tw, int8_t* __restrict__ out, int N) {
  using namespace cl;
  const size_t b = blockIdx.x / kRanks;
  const int p = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  apply_cluster_window<false>(StripI8{raw + b * kW, static_cast<size_t>(N) * kW},
                       Ramp<kM>(advance[b], phase_re[b], phase_im[b]), F, Fi, Tw,
                       ClusterWire{out + b * kW, p});
}

// The float path at m = 256: the cluster of window b = blockIdx.x / 4 of
// the block planes pre/pim bf16 [T, N, m/2, m], with advance float
// [T-1, N], writes the centre half yre[b], yim[b] float [m/2, m].
__global__ void __cluster_dims__(cl::kRanks, 1, 1) __launch_bounds__(cl::kThreads, 1)
apply_planes_cluster_kernel(const __nv_bfloat16* __restrict__ pre,
                            const __nv_bfloat16* __restrict__ pim,
                            const float* __restrict__ advance,
                            const __nv_bfloat16* __restrict__ F,
                            const __nv_bfloat16* __restrict__ Fi, const float2* __restrict__ Tw,
                            float* __restrict__ yre_out, float* __restrict__ yim_out, int N) {
  using namespace cl;
  const size_t b = blockIdx.x / kRanks;
  const size_t top = b * (kW / 2);   // block t of channel n; also the window's output
  const int p = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  apply_cluster_window<true>(StripPlanes{pre + top, pim + top, static_cast<size_t>(N) * (kW / 2)},
                       Ramp<kM>(advance[b], 1.f, 0.f), F, Fi, Tw,
                       ClusterFloat{yre_out + top, yim_out + top, p});
}

int launch_cluster(const void* dre, const void* dim, const void* advance, const void* phase_re,
                   const void* phase_im, const void* Fi, const void* Tw, void* out, int T1, int N,
                   void* stream) {
  const int smem = static_cast<int>(ApplyClusterSmem::kBytes);
  const cudaError_t err = set_smem(apply_spec_cluster_kernel, smem);
  if (err != cudaSuccess) return err;
  apply_spec_cluster_kernel<<<cl::kRanks * T1 * N, cl::kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dre), static_cast<const __nv_bfloat16*>(dim),
      static_cast<const float*>(advance), static_cast<const float*>(phase_re),
      static_cast<const float*>(phase_im), static_cast<const __nv_bfloat16*>(Fi),
      static_cast<const float2*>(Tw), static_cast<int8_t*>(out));
  return cudaGetLastError();
}

int launch_i8_cluster(const void* raw, const void* advance, const void* phase_re,
                      const void* phase_im, const void* F, const void* Fi, const void* Tw,
                      void* out, int T1, int N, void* stream) {
  const int smem = static_cast<int>(ApplyClusterSmem::kBytes);
  const cudaError_t err = set_smem(apply_i8_cluster_kernel, smem);
  if (err != cudaSuccess) return err;
  apply_i8_cluster_kernel<<<cl::kRanks * T1 * N, cl::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(raw), static_cast<const float*>(advance),
      static_cast<const float*>(phase_re), static_cast<const float*>(phase_im),
      static_cast<const __nv_bfloat16*>(F), static_cast<const __nv_bfloat16*>(Fi),
      static_cast<const float2*>(Tw), static_cast<int8_t*>(out), N);
  return cudaGetLastError();
}

int launch_planes_cluster(const void* pre, const void* pim, const void* advance, const void* F,
                          const void* Fi, const void* Tw, void* yre, void* yim, int T1, int N,
                          void* stream) {
  const int smem = static_cast<int>(ApplyClusterSmem::kBytes);
  const cudaError_t err = set_smem(apply_planes_cluster_kernel, smem);
  if (err != cudaSuccess) return err;
  apply_planes_cluster_kernel<<<cl::kRanks * T1 * N, cl::kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pre), static_cast<const __nv_bfloat16*>(pim),
      static_cast<const float*>(advance), static_cast<const __nv_bfloat16*>(F),
      static_cast<const __nv_bfloat16*>(Fi), static_cast<const float2*>(Tw),
      static_cast<float*>(yre),
      static_cast<float*>(yim), N);
  return cudaGetLastError();
}

}  // namespace fused

// dre, dim bf16 [T-1, N, m, m]; advance, phase_re, phase_im float [T-1, N];
// tables Fi (bf16-rounded conj(F)/m) and Tw float2 [m, m] (at m = 256 Fi as
// the packed bf16 k-slices of kernels/fused.py:cluster_slices); out int8
// [T-1, N, m/2, 2m]; m in {64, 128, 256}. Returns the CUDA error code of
// the launch (0 on success); -1 for an unsupported m or no window.
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
    case 256:
      return fused::launch_cluster(dre, dim, advance, phase_re, phase_im, Fi, Tw, out, T1, N,
                                   stream);
    default:
      return -1;
  }
}

// raw int8 [T, N, m/2, 2m]; advance, phase_re, phase_im float [T-1, N];
// tables F, Fi (bf16-rounded) and Tw float2 [m, m] (at m = 256 F and Fi as
// the packed bf16 k-slices of kernels/fused.py:cluster_slices); out int8
// [T-1, N, m/2, 2m]; m in {64, 128, 256}. Returns the CUDA error code of
// the launch (0 on success); -1 for an unsupported m.
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
    case 256:
      return fused::launch_i8_cluster(raw, advance, phase_re, phase_im, F, Fi, Tw, out, T1, N,
                                      stream);
    default:
      return -1;
  }
}

// pre, pim bf16 [T, N, m/2, m]; advance float [T-1, N]; tables F, Fi, Tw
// float2 [m, m] (at m = 256 F and Fi as the packed bf16 k-slices of
// kernels/fused.py:cluster_slices); outputs yre, yim float [T-1, N, m/2, m]; m in {64, 128,
// 256}. Returns the CUDA error code of the launch (0 on success); -1 for an
// unsupported m.
extern "C" int fused_apply_planes(const void* pre, const void* pim, const void* advance,
                                  const void* F, const void* Fi, const void* Tw, void* yre,
                                  void* yim, int T1, int N, int m, void* stream) {
  switch (m) {
    case 64:
      return fused::launch_planes<64>(pre, pim, advance, F, Fi, Tw, yre, yim, T1, N, stream);
    case 128:
      return fused::launch_planes<128>(pre, pim, advance, F, Fi, Tw, yre, yim, T1, N, stream);
    case 256:
      return fused::launch_planes_cluster(pre, pim, advance, F, Fi, Tw, yre, yim, T1, N, stream);
    default:
      return -1;
  }
}
