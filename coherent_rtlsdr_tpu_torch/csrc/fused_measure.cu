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
// Design. On the TPU one grid step carried the reference spectrum R across
// its channels; CUDA blocks share nothing, so on the i8 path a first
// kernel, the same transform in reference mode (fused_measure_ref, one CTA
// a slot t), writes R (float32) and its energy per window, and the channel
// kernel reads them from L2; the float path gets R from the host as bf16
// planes. The products run on the tensor cores with bf16 operands and
// float32 sums, m / 16 warps a CTA, each owning a 16-row strip whose first
// product's twiddled bf16 result stays in registers as the second's A
// fragments: for the reference on mma.sync m16n8k16 (forward_tc in
// fused_common.cuh), for the channels on wgmma m64n32k16 (channel_window:
// a warpgroup a 64-row block, A from registers, B through a descriptor from
// tiled planes, the window N-major in the first product, F K-major in the
// second), which reads each B tile once a warpgroup where ldmatrix read it
// once a warp.
//
// What bounds the channel kernels on the H100 at m = 128 (5,355 windows an
// offline call of T = 256, N = 21): the four real m^3 products of each of
// the two complex products, 33.6 MFLOP a window, 0.18 ms at the bf16
// tensor-core peak (4.5 us a window on one SM's share of it), against
// 0.13 ms of bytes (16 kB of new int8 and, for fused_measure_i8_spec, 64 kB
// of D out a window; R and the twiddle, 2 x 128 kB of float32 a window,
// come from L2). Each CTA walks its windows one after another, so the time
// is one window's serial path on an SM times the windows a CTA.
//
// The i8 channel kernel, measure_kernel<M, STORE_D> (fused_measure_i8_spec
// with the D store, fused_measure_i8 without), is a persistent grid:
// min(windows, CTAs that fit: one an SM at m = 128) CTAs, CTA b walking
// windows b, b + grid, ... on a fixed stride (no work counter, so a
// captured CUDA graph replays it as it is). An offline call walks ~41
// windows a CTA, a server block of 21 windows one. Per CTA:
//   * F is converted to swizzled bf16 planes once and stays resident;
//   * the next window's two int8 blocks are copied into a staging slot by
//     the copy engine (cp.async.bulk, issued by thread 0, completing on an
//     mbarrier) while the CTA measures the current one; a window starts by
//     converting its staged bytes into the window's planes, after which the
//     slot is free for the next copy. The copy needs no thread beyond the
//     one that starts it, so no warp is set apart for it;
//   * the epilogue of the second product stores D (bf16, 16 bytes a lane
//     after a transpose across the 4 lanes of a row, streamed), writes G =
//     D conj(R) (float32) over the window's planes, sums the energies and
//     takes stage 1's 8-row band sums across the 8 lanes of an mma strip
//     with shuffles while G is in registers; only the product of a band
//     with the strip above's last band reads G back (8 rows a column);
//   * the zoom's ramps are row-times-column phasors: the deramp by the
//     integer lag d, e^{2 pi i (r + m c) d / W} = e^{2 pi i r d / W}
//     e^{2 pi i c d / m}, and the fractional zoom, e^{2 pi i frac (r + m
//     c_s) / W} with c_s the signed column, each 2m sincospif a window (one
//     a thread) instead of one an element of G. Stage 2's column sums and
//     z are then one pass over G each, the deramp folded into their row
//     and column weights; every sum stays float32, with the bands, masks
//     and clamp of _phase_zoom_core. Eight barriers a window.
// Measured (H100, 700 W, T = 256, N = 21; PERF.md section 6, row 1): 0.74
// ms a call against 1.57 for one CTA a window that reloaded F, loaded its
// window unoverlapped and took two sincospif an element of G (0.80 with
// both products on mma.sync, which read each B operand once a warp). The
// serial path, ~18 us a window on an SM, is still ~4 times its products'
// share of the peak: the zoom, the epilogue, R's and the twiddle's L2
// reads and the D store run between barriers with the tensor cores idle,
// and F, G and the slot leave no shared memory to hold a second window.
// Shared memory of measure_kernel at m = 128, 232,080 of the 232,448
// bytes a CTA may have (ChannelSmem):
//   table (2 m^2 bf16, 64 kB):   F as tiled re / im planes, resident
//   window (m^2 float2, 128 kB): the window's tiled bf16 planes, then G
//                                 (columns swizzled by row parity)
//   scratch (2,688 bytes):        the zoom's 2m phasors, its m/2 pair-band
//                                 sums, the reduction scratch
//   barrier (16 bytes), slot (2 m^2 int8, 32 kB): the next window's bytes
// The float kernel, measure_planes_kernel, runs channel_window one CTA a
// window, with the window's bf16 planes (load_window_planes) and R as bf16
// planes: the same layout without the slot and its barrier.
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
// channel_window does below m = 256. The second product's D is staged as
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

// Shared memory of the reference kernel (kTcThreads<M> threads): F's and
// the window's bf16 planes, the block_sum scratch.
template <int M>
struct RefSmem {
  static constexpr size_t kTable = 2 * sizeof(__nv_bfloat16) * M * M;
  static constexpr size_t kBytes = 2 * kTable + sizeof(float) * (kTcThreads<M> / 32);
};

// Shared memory of the channel kernels at m in {64, 128} (kTcThreads<M>
// threads): F's tiled planes at 0, kept for every window of the CTA; from
// kWin the window's tiled planes (2 m^2 bf16), then G (m^2 float2); at kScratch the
// zoom's 2m phasors, its m/2 pair-band sums and the reduction scratch
// (block_sums, four values). measure_planes_kernel ends there
// (kPlanesBytes); measure_kernel adds the staging slot's barrier and, at
// kSlot, the slot: the next window's 2 m^2 int8 bytes.
template <int M>
struct ChannelSmem {
  static constexpr size_t kWin = 2 * sizeof(__nv_bfloat16) * M * M;
  static constexpr size_t kScratch = kWin + sizeof(float2) * M * M;
  static constexpr size_t kPlanesBytes =
      kScratch + sizeof(float2) * (2 * M + M / 2) + sizeof(float) * 4 * (kTcThreads<M> / 32);
  static constexpr size_t kBar = (kPlanesBytes + 15) / 16 * 16;
  static constexpr size_t kSlot = kBar + 16;
  static constexpr size_t kBytes = kSlot + 2 * M * M;
  static_assert(kBytes <= 232448, "a CTA's shared memory on the H100");
};

// block_sum of K values at once, behind one barrier for all of them:
// every thread gets the K sums. `red` holds K NT / 32 floats; the caller
// has passed a barrier since the last read of red (an earlier call's).
template <int NT, int K>
__device__ __forceinline__ void block_sums(float (&v)[K], float* red) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[(threadIdx.x >> 5) * K + k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += red[w * K + k];
    v[k] = s;
  }
}

// The int8 window at `top` (its first block; the second `next` bytes on)
// into the staging slot, both blocks in order, by one thread: the slot's
// barrier armed with both copies' bytes.
template <int M>
__device__ __forceinline__ void stage_window(const int8_t* top, size_t next, int8_t* slot,
                                             uint64_t* bar) {
  constexpr uint32_t kBlock = M * M;  // bytes of a block [m/2, 2m]
  cl::mbar_arm(bar, 2 * kBlock);
  bulk_load(slot, top, kBlock, bar);
  bulk_load(slot + kBlock, top + next, kBlock, bar);
}

// The staged window (2 m^2 bytes) into tiled bf16 re / im planes at `win`
// (`tiled`), as load_window_i8 converts it, fenced for wgmma.
template <int M>
__device__ __forceinline__ void window_from_slot(const int8_t* slot, __nv_bfloat16* win) {
  constexpr int kThreads = kTcThreads<M>;
  constexpr int kSteps = 2 * M * M / 16 / kThreads;
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int q = threadIdx.x + u * kThreads;
    store_i8_vector<M, true>(reinterpret_cast<const int4*>(slot)[q], q, win);
  }
  fence_for_wgmma();
}

// The twiddle that tc::twiddle_to_a reads for chunk cc of the strip at r0:
// elements (r, c), (r, c + 1) of tile jt, row half hh. Loaded ahead of the
// chunk's product, which hides L2's latency.
template <int M>
__device__ __forceinline__ void load_twiddle(const float2* __restrict__ Tw, int r0, int cc,
                                             float4 (&tw)[tc::kChunkTiles][2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jt = 0; jt < tc::kChunkTiles; ++jt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      tw[jt][hh] = __ldg(reinterpret_cast<const float4*>(
          Tw + (r0 + g + 8 * hh) * M + cc * tc::kChunk + jt * 8 + 2 * t));
}

// tc::twiddle_to_a (forward) on the twiddle of load_twiddle.
template <int M>
__device__ __forceinline__ void twiddle_into_a(const float (&are)[tc::kChunkTiles][4],
                                               const float (&aim)[tc::kChunkTiles][4],
                                               const float4 (&tw)[tc::kChunkTiles][2], int cc,
                                               uint32_t (&cre)[M / 16][4],
                                               uint32_t (&cim)[M / 16][4]) {
#pragma unroll
  for (int jt = 0; jt < tc::kChunkTiles; ++jt) {
    const int kt = cc * tc::kChunkTiles + jt;  // n8 tile index across the strip
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float4 w = tw[jt][hh];
      const float2 v0 = tc::twiddle<false>(are[jt][2 * hh], aim[jt][2 * hh], w.x, w.y);
      const float2 v1 = tc::twiddle<false>(are[jt][2 * hh + 1], aim[jt][2 * hh + 1], w.z, w.w);
      cre[kt / 2][(kt & 1) * 2 + hh] = tc::pack_bf16(v0.x, v1.x);
      cim[kt / 2][(kt & 1) * 2 + hh] = tc::pack_bf16(v0.y, v1.y);
    }
  }
}

// Index of G's element (r, c) in its float2 [m][m]: column c ^ 8 on odd
// rows, so that the epilogue's 16-byte stores (8 rows of 4 lanes) fill
// whole 128-byte wavefronts with two rows each.
template <int M>
__device__ __forceinline__ int gidx(int r, int c) {
  return r * M + (c ^ ((r & 1) << 3));
}

// Stage 1's band sums from the epilogue's registers. x[s][k]: this lane's
// G values of column cc kC + 8 jt + 2t + e (s = 2 jt + e) in row r0 + g +
// 8 hh, as (re, im) at k = 2 hh, 2 hh + 1. The sum over the 8 lanes g of
// each t is the column's band 2 wp (hh = 0) or 2 wp + 1 (hh = 1). Summed
// by recursive halving over the three lane bits of g: lane g ends with the
// four sums of s = g, each of the 8 values added once.
__device__ __forceinline__ void band_sums(const float (&x)[8][4], int g, float (&out)[4]) {
  float y[4][4], z[2][4];
  const bool g2 = g & 4, g1 = g & 2, g0 = g & 1;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float lo = x[s][k], hi = x[s + 4][k];
      y[s][k] = (g2 ? hi : lo) + __shfl_xor_sync(0xffffffffu, g2 ? lo : hi, 16);
    }
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float lo = y[s][k], hi = y[s + 2][k];
      z[s][k] = (g1 ? hi : lo) + __shfl_xor_sync(0xffffffffu, g1 ? lo : hi, 8);
    }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lo = z[0][k], hi = z[1][k];
    out[k] = (g0 ? hi : lo) + __shfl_xor_sync(0xffffffffu, g0 ? lo : hi, 4);
  }
}

// The 4 x 4 transpose of 32-bit words across the four lanes t of a quad
// (lanes 4g .. 4g + 3): lane t holds w[j] = word j of lane-row t and ends
// with word t of lane-rows 0..3, in order. Two exchanges of halves.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&w)[4], int t) {
  const bool b1 = t & 2, b0 = t & 1;
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t r = __shfl_xor_sync(0xffffffffu, b1 ? w[i] : w[i + 2], 2);
    v[i] = b1 ? r : w[i];
    v[i + 2] = b1 ? w[i + 2] : r;
  }
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    const uint32_t r = __shfl_xor_sync(0xffffffffu, b0 ? v[i] : v[i + 1], 1);
    o[i] = b0 ? r : v[i];
    o[i + 1] = b0 ? v[i + 1] : r;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// acc = F A over this warpgroup's 64 rows (this warp's 16, r0..r0+15)
// and chunk cc's kChunk columns, on wgmma: F's A fragments from its tiled
// planes through ldmatrix, all M / 16 k steps held, and the window A from
// its tiled planes as the N-major B (the next 8 n 128 bytes on, the next 8
// k (m / 8) x 128): re = Fr Ar - Fi Ai, im = Fr Ai + Fi Ar, four m64n32k16
// products a k step, all waited for before it returns.
template <int M>
__device__ __forceinline__ void first_product(const __nv_bfloat16* fre, const __nv_bfloat16* fim,
                                              int r0, const __nv_bfloat16* wre,
                                              const __nv_bfloat16* wim, int cc,
                                              float (&are)[tc::kChunkTiles][4],
                                              float (&aim)[tc::kChunkTiles][4]) {
  static_assert(tc::kChunk == 32, "m64n32k16");
  const int l = threadIdx.x & 31;
  uint32_t fr[M / 16][4], fi[M / 16][4];
#pragma unroll
  for (int ks = 0; ks < M / 16; ++ks) {
    // The A fragment of rows r0..r0+15, k 16 ks..16 ks + 15 (tc::ldsm_a's lanes).
    const int o = tiled<M>(r0 + (l & 15), ks * 16 + (l >> 4) * 8);
    tc::ldsm_x4(tc::smem_addr(fre + o), fr[ks]);
    tc::ldsm_x4(tc::smem_addr(fim + o), fi[ks]);
  }
#pragma unroll
  for (int i = 0; i < tc::kChunkTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) are[i][e] = aim[i][e] = 0.f;
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < M / 16; ++ks) {
    const int o = tiled<M>(16 * ks, cc * tc::kChunk);
    const uint64_t bre = tc::desc_k(wre + o, (M / 8) * 128, 128);
    const uint64_t bim = tc::desc_k(wim + o, (M / 8) * 128, 128);
    tc::wgmma<32, 1, 1>(are, fr[ks], bre);
    tc::wgmma<32, -1, 1>(are, fi[ks], bim);
    tc::wgmma<32, 1, 1>(aim, fr[ks], bim);
    tc::wgmma<32, 1, 1>(aim, fi[ks], bre);
  }
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
}

// acc = C F over this warpgroup's 64 rows (this warp's 16: C's A
// fragments, cre / cim) and the kChunk columns from n_base, on wgmma with F
// from its tiled planes: re = Cr Fr - Ci Fi, im = Cr Fi + Ci Fr, four
// m64n32k16 products a k step, all waited for before it returns. A warp
// reads F's tiles once a warpgroup instead of once a warp (ldmatrix).
template <int M>
__device__ __forceinline__ void second_product(const uint32_t (&cre)[M / 16][4],
                                               const uint32_t (&cim)[M / 16][4],
                                               const __nv_bfloat16* fre,
                                               const __nv_bfloat16* fim, int n_base,
                                               float (&dre)[tc::kChunkTiles][4],
                                               float (&dim)[tc::kChunkTiles][4]) {
  static_assert(tc::kChunk == 32, "m64n32k16");
#pragma unroll
  for (int i = 0; i < tc::kChunkTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dre[i][e] = dim[i][e] = 0.f;
  tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < M / 16; ++kk) {
    const int o = tiled<M>(n_base, 16 * kk);
    const uint64_t bre = tc::desc_k(fre + o, 128, (M / 8) * 128);
    const uint64_t bim = tc::desc_k(fim + o, 128, (M / 8) * 128);
    tc::wgmma<32, 1>(dre, cre[kk], bre);
    tc::wgmma<32, -1>(dre, cim[kk], bim);
    tc::wgmma<32, 1>(dim, cre[kk], bim);
    tc::wgmma<32, 1>(dim, cim[kk], bre);
  }
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
}

struct ZoomResult {
  float lag, zre, zim;  // the same values in every thread
};

// The channel body at m in {64, 128}: the forward transform of window w
// (slot t) from its swizzled bf16 planes at `win` (F's at `tab`), the
// cross-spectrum G = D conj(R) over the planes, and the two-stage banded
// phase-slope estimator (_phase_zoom_core) on it; `scratch` is
// ChannelSmem's. r_at(r, c) returns R's elements (r, c), (r, c + 1) as
// float4 (re, im, re, im); where Out::kStoresD, out.d16(o, re, im) gets
// eight D elements (r, c..c + 7) at element offset o of the window's
// spectrum as bf16 planes' 16 bytes each, and out.scalars(t, w, z, esig,
// eg) runs on thread 0 with the window's sums. Every thread of the CTA
// calls it behind a barrier after the planes were written, and it returns
// behind a barrier after its last read of G and of the scratch.
template <int M, class RAt, class Out>
__device__ __forceinline__ void channel_window(const __nv_bfloat16* tab, __nv_bfloat16* win,
                                               unsigned char* scratch,
                                               const float2* __restrict__ Tw, int t, size_t w,
                                               RAt r_at, const Out& out) {
  constexpr int W = M * M;
  constexpr int NT = kTcThreads<M>;
  constexpr int kC = tc::kChunk, kCT = tc::kChunkTiles, kChunks = M / kC;
  static_assert(kCT == 4, "band_sums and quad_transpose take the 4 tiles of a chunk");
  float2* G = reinterpret_cast<float2*>(win);
  float2* ph = reinterpret_cast<float2*>(scratch);  // [2m]: rows, then columns
  float2* g2 = ph + 2 * M;                          // [m/2]
  float* red = reinterpret_cast<float*>(g2 + M / 2);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wp = threadIdx.x >> 5, r0 = 16 * wp;

  // --- D = (F A * T) F on wgmma, with the twiddle and R of a chunk read
  // from L2 before its product (a chunk further ahead ran slower: 0.06 ms a
  // call at m = 128, T = 256).
  uint32_t cre[M / 16][4], cim[M / 16][4];
#pragma unroll
  for (int cc = 0; cc < kChunks; ++cc) {
    float4 tw[kCT][2];
    load_twiddle<M>(Tw, r0, cc, tw);
    float are[kCT][4], aim[kCT][4];
    first_product<M>(tab, tab + W, r0, win, win + W, cc, are, aim);
    twiddle_into_a<M>(are, aim, tw, cc, cre, cim);
  }
  __syncthreads();  // every warp has read the window: G may overwrite it

  // The second product a chunk at a time, and its epilogue: D to the
  // writer (each row's 32 bf16 a plane turned from four lanes' pairs into
  // one lane's 16 bytes by quad_transpose), G into shared memory, the
  // energies, and stage 1 in registers: lane g of t gets the sums of bands
  // 2 wp (b0) and 2 wp + 1 of column cc kC + 8 (g / 2) + 2 tq + g % 2
  // (band_sums) and adds their adjacent-band product.
  float esig = 0.f, eg = 0.f, s1re = 0.f, s1im = 0.f;
  float2 b0[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) b0[i] = make_float2(0.f, 0.f);
#pragma unroll 1
  for (int cc = 0; cc < kChunks; ++cc) {
    float4 rr[kCT][2];
#pragma unroll
    for (int jt = 0; jt < kCT; ++jt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) rr[jt][hh] = r_at(r0 + g + 8 * hh, cc * kC + 8 * jt + 2 * tq);
    float dre[kCT][4], dim[kCT][4];
    second_product<M>(cre, cim, tab, tab + W, cc * kC, dre, dim);
    float x[2 * kCT][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + g + 8 * hh;
      uint32_t wre[kCT], wim[kCT];
#pragma unroll
      for (int jt = 0; jt < kCT; ++jt) {
        const int c = cc * kC + 8 * jt + 2 * tq;
        const float4 d = make_float4(dre[jt][2 * hh], dim[jt][2 * hh], dre[jt][2 * hh + 1],
                                     dim[jt][2 * hh + 1]);
        wre[jt] = tc::pack_bf16(d.x, d.z);
        wim[jt] = tc::pack_bf16(d.y, d.w);
        const float4 rv = rr[jt][hh];
        const float g0re = d.x * rv.x + d.y * rv.y, g0im = d.y * rv.x - d.x * rv.y;
        const float g1re = d.z * rv.z + d.w * rv.w, g1im = d.w * rv.z - d.z * rv.w;
        *reinterpret_cast<float4*>(G + gidx<M>(r, c)) = make_float4(g0re, g0im, g1re, g1im);
        esig += d.x * d.x + d.y * d.y + d.z * d.z + d.w * d.w;
        eg += g0re * g0re + g0im * g0im + g1re * g1re + g1im * g1im;
        x[2 * jt][2 * hh] = g0re;
        x[2 * jt][2 * hh + 1] = g0im;
        x[2 * jt + 1][2 * hh] = g1re;
        x[2 * jt + 1][2 * hh + 1] = g1im;
      }
      if constexpr (Out::kStoresD)
        out.d16(w * W + r * M + cc * kC + 8 * tq, quad_transpose(wre, tq), quad_transpose(wim, tq));
    }
    float band[4];
    band_sums(x, g, band);
    s1re += band[2] * band[0] + band[3] * band[1];  // band 2 wp + 1 times conj(band 2 wp)
    s1im += band[3] * band[0] - band[2] * band[1];
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      if (i == cc) b0[i] = make_float2(band[0], band[1]);
  }
  __syncthreads();  // G complete

  // --- Stage 1 across the strips: band 2 wp times conj(band 2 wp - 1, the
  // last 8 rows of the strip above, read back from G) in the same column;
  // on warp 0, band 0 of column c times conj(the last band of column c - 1),
  // except at c = 0 and across the Nyquist straddle c - 1 = m/2 - 1.
#pragma unroll
  for (int cc = 0; cc < kChunks; ++cc) {
    const int c = cc * kC + 8 * (g >> 1) + 2 * tq + (g & 1);
    const int rp = wp > 0 ? r0 - 8 : M - 8;
    const int cp = wp > 0 ? c : c - 1;
    if (wp > 0 || (c >= 1 && c - 1 != M / 2 - 1)) {
      float pr = 0.f, pi = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float2 v = G[gidx<M>(rp + q, cp)];
        pr += v.x;
        pi += v.y;
      }
      s1re += b0[cc].x * pr + b0[cc].y * pi;
      s1im += b0[cc].y * pr - b0[cc].x * pi;
    }
  }
  float s1[2] = {s1re, s1im};
  block_sums<NT, 2>(s1, red);
  constexpr float kStage1 = static_cast<float>((W / 8) / 6.283185307179586);
  const float int_lag = rintf(-atan2f(s1[1], s1[0]) * kStage1);

  // --- Stage 2: the deramp by the integer lag d is a row phasor times a
  // column phasor, e^{2 pi i k d / W} = e^{2 pi i r d / W} e^{2 pi i c d / m}
  // for k = r + m c: thread i < m makes row i's, thread m + c column c's
  // (sin / cos of 2 pi f, f in [0, 1), with sincospif's exact argument
  // reduction).
  const int neg_lag = -static_cast<int>(int_lag);
  const int i = threadIdx.x;
  float2 own;
  {
    const float f = i < M ? iramp_fraction<W>(static_cast<uint32_t>(i), neg_lag)
                          : iramp_fraction<M>(static_cast<uint32_t>(i - M), neg_lag);
    float s, co;
    sincospif(2.f * f, &s, &co);
    own = make_float2(co, s);
    ph[i] = own;
  }
  __syncthreads();
  // The passes over G: thread (column pair pc, quarter q) takes columns
  // 2 pc, 2 pc + 1 (16 bytes) of rows 4k + q, weighted by the row phasor
  // ph[r]; the quarters meet across lanes l ^ 8, l ^ 16.
  const int pc = 8 * wp + (lane & 7), q4 = lane >> 3;
  const auto pass = [&](auto weigh) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int k = 0; k < M / 4; ++k) {
      const int r = 4 * k + q4;
      const float4 v = *reinterpret_cast<const float4*>(G + gidx<M>(r, 2 * pc));
      weigh(a, v, ph[r]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[e] += __shfl_xor_sync(0xffffffffu, a[e], 8);
      a[e] += __shfl_xor_sync(0xffffffffu, a[e], 16);
    }
    return make_float4(a[0], a[1], a[2], a[3]);
  };
  {
    // Column sums of G conj(row phasor), then conj(column phasor): the
    // pair-band sum g2[pc] = col[2 pc] + col[2 pc + 1].
    const float4 s = pass([](float (&a)[4], float4 v, float2 p) {
      a[0] += v.x * p.x + v.y * p.y;
      a[1] += v.y * p.x - v.x * p.y;
      a[2] += v.z * p.x + v.w * p.y;
      a[3] += v.w * p.x - v.z * p.y;
    });
    const float2 qa = ph[M + 2 * pc], qb = ph[M + 2 * pc + 1];
    if (q4 == 0)
      g2[pc] = make_float2(s.x * qa.x + s.y * qa.y + s.z * qb.x + s.w * qb.y,
                           s.y * qa.x - s.x * qa.y + s.w * qb.x - s.z * qb.y);
  }
  __syncthreads();
  // Adjacent pair-band products, the Nyquist pair M2/2 - 1 masked; every
  // warp sums them in the same order, so every thread has the same frac.
  constexpr int M2 = M / 2;
  float s2re = 0.f, s2im = 0.f;
  for (int b = lane + 1; b < M2; b += 32) {
    if (b - 1 == M2 / 2 - 1) continue;
    const float2 cur = g2[b], prev = g2[b - 1];
    s2re += cur.x * prev.x + cur.y * prev.y;
    s2im += cur.y * prev.x - cur.x * prev.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s2re += __shfl_xor_sync(0xffffffffu, s2re, o);
    s2im += __shfl_xor_sync(0xffffffffu, s2im, o);
  }
  constexpr float kStage2 = static_cast<float>(M2 / 6.283185307179586);
  const float frac = fminf(fmaxf(-atan2f(s2im, s2re) * kStage2, -4.f), 4.f);

  // --- z = sum G' e^{2 pi i frac f_k} over the deramped G': f_k = (r + m
  // c_s) / W, c_s the signed column (c - m from the Nyquist column on), so
  // the weight is again a row phasor times a column phasor; each is folded
  // with conj(the deramp's) into ph.
  {
    const float wz = 2.f * frac;  // in units of pi
    const int cs = i - M < M / 2 ? i - M : i - 2 * M;
    const float f = i < M ? static_cast<float>(i) * (1.f / W) : static_cast<float>(cs) * (1.f / M);
    float s, co;
    sincospif(wz * f, &s, &co);
    ph[i] = make_float2(own.x * co + own.y * s, own.x * s - own.y * co);
  }
  __syncthreads();
  const float4 za = pass([](float (&a)[4], float4 v, float2 p) {
    a[0] += v.x * p.x - v.y * p.y;
    a[1] += v.x * p.y + v.y * p.x;
    a[2] += v.z * p.x - v.w * p.y;
    a[3] += v.z * p.y + v.w * p.x;
  });
  float sums[4] = {0.f, 0.f, esig, eg};
  if (q4 == 0) {
    const float2 qa = ph[M + 2 * pc], qb = ph[M + 2 * pc + 1];
    sums[0] = za.x * qa.x - za.y * qa.y + za.z * qb.x - za.w * qb.y;
    sums[1] = za.x * qa.y + za.y * qa.x + za.z * qb.y + za.w * qb.x;
  }
  block_sums<NT, 4>(sums, red);
  if (threadIdx.x == 0)
    out.scalars(t, w, ZoomResult{int_lag + frac, sums[0], sums[1]}, sums[2], sums[3]);
}

// Reference mode: one CTA per window t writes R[t] (float2 [m, m]) and
// eref[t] = sum |R|^2.
template <int M>
__global__ void __launch_bounds__(kTcThreads<M>)
measure_ref_kernel(const int8_t* __restrict__ ref_raw, const float2* __restrict__ F,
                   const float2* __restrict__ Tw, float2* __restrict__ R,
                   float* __restrict__ eref) {
  using S = RefSmem<M>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem + S::kTable);
  float* red = reinterpret_cast<float*>(smem + 2 * S::kTable);

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

// The i8 channel kernels' outputs: lag, zre, zim, mag, papr float [T-1, N]
// against the reference energies eref, and with STORE_D the window
// spectrum D as bf16 (the handoff pair); without it the stores compile away
// and the two pointers are not read.
template <bool STORE_D>
struct I8Out {
  static constexpr bool kStoresD = STORE_D;
  const float* eref;
  float *lag, *zre, *zim, *mag, *papr;
  __nv_bfloat16 *dre, *dim;

  __device__ __forceinline__ void d(size_t o, float4 v) const {
    if constexpr (STORE_D) {
      *reinterpret_cast<__nv_bfloat162*>(dre + o) = __floats2bfloat162_rn(v.x, v.z);
      *reinterpret_cast<__nv_bfloat162*>(dim + o) = __floats2bfloat162_rn(v.y, v.w);
    }
  }

  // Eight elements of each plane at element offset o (a multiple of 8),
  // streamed (evict first): the apply reads D back from device memory, and
  // L2 keeps R and the twiddle, which every window reads (0.05 ms less a
  // call at m = 128, T = 256).
  __device__ __forceinline__ void d16(size_t o, uint4 re, uint4 im) const {
    __stcs(reinterpret_cast<uint4*>(dre + o), re);
    __stcs(reinterpret_cast<uint4*>(dim + o), im);
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
  static constexpr bool kStoresD = false;
  float *lag, *zabs, *esig, *eg;

  __device__ __forceinline__ void d(size_t, float4) const {}
  __device__ __forceinline__ void d16(size_t, uint4, uint4) const {}

  __device__ __forceinline__ void scalars(int, size_t win, ZoomResult z, float e_sig,
                                          float e_g) const {
    lag[win] = z.lag;
    zabs[win] = sqrtf(z.zre * z.zre + z.zim * z.zim);
    esig[win] = e_sig;
    eg[win] = e_g;
  }
};

// Channel mode of the i8 path at m in {64, 128}: int8 blocks raw [T, N,
// m/2, 2m] against R float2 [T-1, m, m] and eref from measure_ref_kernel.
// A persistent grid over the B = (T-1) N windows w = t N + n: CTA b takes
// w = b, b + gridDim.x, ... Thread 0 stages the next window's bytes while
// the CTA measures this one.
template <int M, bool STORE_D>
__global__ void __launch_bounds__(kTcThreads<M>, 1)
measure_kernel(const int8_t* __restrict__ raw, const float2* __restrict__ F,
               const float2* __restrict__ Tw, const float2* __restrict__ R,
               const float* __restrict__ eref, float* __restrict__ lag_out,
               float* __restrict__ zre_out, float* __restrict__ zim_out,
               float* __restrict__ mag_out, float* __restrict__ papr_out,
               __nv_bfloat16* __restrict__ dre_out, __nv_bfloat16* __restrict__ dim_out, int T1,
               int N) {
  constexpr int W = M * M;
  using S = ChannelSmem<M>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem + S::kWin);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::kBar);
  int8_t* slot = reinterpret_cast<int8_t*>(smem + S::kSlot);
  const size_t B = static_cast<size_t>(T1) * N;
  const size_t next = static_cast<size_t>(N) * W;  // a block to the channel's next block

  if (threadIdx.x == 0) {
    cl::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_table<M, kTcThreads<M>, true>(F, tab);
  fence_for_wgmma();
  __syncthreads();
  if (threadIdx.x == 0) stage_window<M>(raw + blockIdx.x * static_cast<size_t>(W), next, slot, bar);
  const I8Out<STORE_D> out{eref, lag_out, zre_out, zim_out, mag_out, papr_out, dre_out, dim_out};
  int parity = 0;
  for (size_t w = blockIdx.x; w < B; w += gridDim.x, parity ^= 1) {
    cl::mbar_wait(bar, parity);
    window_from_slot<M>(slot, win);
    __syncthreads();  // the slot is read: the next window's bytes may land in it
    if (threadIdx.x == 0 && w + gridDim.x < B) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      stage_window<M>(raw + (w + gridDim.x) * W, next, slot, bar);
    }
    const int t = static_cast<int>(w / N);
    const float2* Rt = R + static_cast<size_t>(t) * W;
    channel_window<M>(
        tab, win, smem + S::kScratch, Tw, t, w,
        [&](int r, int c) { return __ldg(reinterpret_cast<const float4*>(Rt + r * M + c)); },
        out);
  }
}

// The float path: block planes pre/pim bf16 [T, N, m/2, m] against the
// reference spectra rre/rim bf16 [T-1, m, m]. One CTA per (t, n) =
// (blockIdx.y, blockIdx.x).
template <int M>
__global__ void __launch_bounds__(kTcThreads<M>, 1)
measure_planes_kernel(const __nv_bfloat16* __restrict__ pre, const __nv_bfloat16* __restrict__ pim,
                      const __nv_bfloat16* __restrict__ rre, const __nv_bfloat16* __restrict__ rim,
                      const float2* __restrict__ F, const float2* __restrict__ Tw,
                      float* __restrict__ lag_out, float* __restrict__ zabs_out,
                      float* __restrict__ esig_out, float* __restrict__ eg_out) {
  constexpr int W = M * M;
  using S = ChannelSmem<M>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem + S::kWin);
  const int n = blockIdx.x;
  const int N = gridDim.x;
  const int t = blockIdx.y;
  const size_t w = static_cast<size_t>(t) * N + n;
  const size_t top = w * (W / 2);  // block t of channel n
  const unsigned int* Rre = reinterpret_cast<const unsigned int*>(rre + static_cast<size_t>(t) * W);
  const unsigned int* Rim = reinterpret_cast<const unsigned int*>(rim + static_cast<size_t>(t) * W);
  load_table<M, kTcThreads<M>, true>(F, tab);
  fence_for_wgmma();
  load_window_planes<M, true>(pre + top, pim + top, static_cast<size_t>(N) * (W / 2), win);
  fence_for_wgmma();
  __syncthreads();
  channel_window<M>(
      tab, win, smem + S::kScratch, Tw, t, w,
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
  const int smem = static_cast<int>(RefSmem<M>::kBytes);
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
  static int capacity[tc::kMaxDevices];  // the persistent grid's occupancy, a device
  const int smem = static_cast<int>(ChannelSmem<M>::kBytes);
  const int grid = tc::persistent_grid(measure_kernel<M, STORE_D>, kTcThreads<M>, smem, T1 * N,
                                       capacity);
  if (grid < 0) return -grid;
  measure_kernel<M, STORE_D><<<grid, kTcThreads<M>, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(raw), static_cast<const float2*>(F),
      static_cast<const float2*>(Tw), static_cast<const float2*>(R),
      static_cast<const float*>(eref), static_cast<float*>(lag), static_cast<float*>(zre),
      static_cast<float*>(zim), static_cast<float*>(mag), static_cast<float*>(papr),
      static_cast<__nv_bfloat16*>(dre), static_cast<__nv_bfloat16*>(dim), T1, N);
  return cudaGetLastError();
}

template <int M>
int launch_planes(const void* pre, const void* pim, const void* rre, const void* rim,
                  const void* F, const void* Tw, void* lag, void* zabs, void* esig, void* eg,
                  int T1, int N, void* stream) {
  const int smem = static_cast<int>(ChannelSmem<M>::kPlanesBytes);
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
