// The m = 256 (W = 65536, L = 32768) kernels run a window on a thread-block
// cluster of four CTAs: every measure kernel (fused_measure.cu:
// measure_ref_cluster_kernel, measure_cluster_kernel,
// measure_planes_cluster_kernel), every apply kernel (fused_apply.cu:
// apply_spec_cluster_kernel, apply_i8_cluster_kernel,
// apply_planes_cluster_kernel) and the four-step FFT (fourstep.cu:
// fourstep_cluster_kernel). This header holds what they share: the strip
// and row-block loaders of each input format, the forward transform and
// the inverse.
//
// Why a cluster. At m = 256 one CTA cannot hold a window: the m = 64 / 128
// kernels keep the table (2 m^2 bf16) and the window or G (m^2 float2) in
// shared memory, 786 kB here against the 227 kB a CTA may use, and give a
// warp a 16-row strip at full width, 16 m complex float32 accumulators (256
// registers a thread here, against 255). So the window is cut four ways, and
// the CTAs of a cluster trade their pieces through distributed shared memory
// (cooperative_groups' this_cluster: map_shared_rank, sync):
//   * a strip is the 64 columns [64 q, 64 q + 64) of all 256 rows of an
//     m x m matrix, swizzled bf16 re / im planes [256][64] (tc::swz<64>);
//   * a row block is the 64 rows [64 p, 64 p + 64) at full width, swizzled
//     bf16 planes [64][256] (tc::swz<256>).
// A forward transform D = (F A * T) F is then, on CTA rank q: B = F A on
// strip q of the window, C = bf16(B * T) as strip q; a cluster barrier;
// row block q of C gathered from the four strips; D = C F on row block q
// (forward_cluster). The inverse is its mirror: row blocks first, then
// strips (inverse_cluster).
//
// The tables F, Fi (bf16-exact float32 pairs [m][m], symmetric) and T are
// not staged in shared memory (F alone is 256 kB as bf16): every product
// reads its table operand from L2 straight into mma fragments, converting
// to bf16 exactly, while the other operand comes from shared memory through
// ldmatrix. A warp computes a 16-row x 32-column tile (tc::kChunk) at a
// time, 32 float32 accumulators a thread; 16 warps a CTA.

#pragma once

#include <cooperative_groups.h>

#include "fused_common.cuh"

namespace fused {
namespace cl {

namespace cg = cooperative_groups;

constexpr int kM = 256;
constexpr int kW = kM * kM;
constexpr int kRanks = 4;             // CTAs a window (the cluster)
constexpr int kPart = kM / kRanks;    // rows of a row block, columns of a strip
constexpr int kThreads = 512;         // 16 warps a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kPlane = kM * kPart;    // bf16 elements of one plane of a strip or row block
constexpr size_t kBuf = 2 * kPlane * sizeof(__nv_bfloat16);   // a strip or row block, 64 kB
constexpr int kTiles = tc::kChunkTiles;   // n8 tiles of a 32-column tile

// The A fragment (re, im) of rows r0..r0+15 and columns k0..k0+15 of a
// float32-pair table [kM][kM] of bf16-exact values, from L2: a0 (g, 2t),
// a1 (g+8, 2t), a2 (g, 2t+8), a3 (g+8, 2t+8), each pair one 16-byte load.
__device__ __forceinline__ void table_a(const float2* __restrict__ tab, int r0, int k0,
                                        uint32_t (&re)[4], uint32_t (&im)[4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + 8 * (i & 1);
    const int k = k0 + 2 * t + 8 * (i >> 1);
    const float4 v = __ldg(reinterpret_cast<const float4*>(tab + r * kM + k));
    re[i] = tc::pack_bf16(v.x, v.z);
    im[i] = tc::pack_bf16(v.y, v.w);
  }
}

// The B fragment (re, im) of the n8 tile n0..n0+7 at k0..k0+15 of a
// symmetric table (B[k][n] = tab[n][k]): b0 = (k0 + 2t.., n0 + g) and b1 =
// (k0 + 2t + 8.., n0 + g), two consecutive elements of row n0 + g each.
__device__ __forceinline__ void table_b(const float2* __restrict__ tab, int n0, int k0,
                                        uint32_t (&re)[2], uint32_t (&im)[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(tab + (n0 + g) * kM + k0 + 2 * t + 8 * i));
    re[i] = tc::pack_bf16(v.x, v.z);
    im[i] = tc::pack_bf16(v.y, v.w);
  }
}

__device__ __forceinline__ void zero(float (&re)[kTiles][4], float (&im)[kTiles][4]) {
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) re[i][e] = im[i][e] = 0.f;
}

// acc = tab[r0..r0+15, :] S[:, c0..c0+31], S a strip (planes sre, sim,
// stored [k][n]): the table rows as A fragments from L2, the strip as B
// fragments through transposed ldmatrix.
__device__ __forceinline__ void table_x_strip(const float2* __restrict__ tab, int r0,
                                              const __nv_bfloat16* sre,
                                              const __nv_bfloat16* sim, int c0,
                                              float (&are)[kTiles][4],
                                              float (&aim)[kTiles][4]) {
  zero(are, aim);
#pragma unroll 1
  for (int ks = 0; ks < kM / 16; ++ks) {
    uint32_t fre[4], fim[4], fnim[4];
    table_a(tab, r0, ks * 16, fre, fim);
    tc::negate(fim, fnim);
#pragma unroll
    for (int p = 0; p < kTiles / 2; ++p) {
      uint32_t bre[4], bim[4];
      tc::ldsm_b_trans<kPart>(sre, c0 + p * 16, ks * 16, bre);
      tc::ldsm_b_trans<kPart>(sim, c0 + p * 16, ks * 16, bim);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        tc::cmma(are[2 * p + h], aim[2 * p + h], fre, fim, fnim, bre[2 * h], bre[2 * h + 1],
                 bim[2 * h], bim[2 * h + 1]);
    }
  }
}

// acc = X[r0..r0+15, :] tab[:, c0..c0+31], X a row block (planes xre, xim):
// the block's rows as A fragments through ldmatrix, the symmetric table as
// B fragments from L2.
__device__ __forceinline__ void block_x_table(const __nv_bfloat16* xre, const __nv_bfloat16* xim,
                                              int r0, const float2* __restrict__ tab, int c0,
                                              float (&are)[kTiles][4],
                                              float (&aim)[kTiles][4]) {
  zero(are, aim);
#pragma unroll 1
  for (int ks = 0; ks < kM / 16; ++ks) {
    uint32_t xr[4], xi[4], xni[4];
    tc::ldsm_a<kM>(xre, r0, ks * 16, xr);
    tc::ldsm_a<kM>(xim, r0, ks * 16, xi);
    tc::negate(xi, xni);
#pragma unroll
    for (int jt = 0; jt < kTiles; ++jt) {
      uint32_t tre[2], tim[2];
      table_b(tab, c0 + 8 * jt, ks * 16, tre, tim);
      tc::cmma(are[jt], aim[jt], xr, xi, xni, tre[0], tre[1], tim[0], tim[1]);
    }
  }
}

// Each pair of finished elements of a 16 x 32 tile at (r0, c0): epi(r, c,
// float4(re_c, im_c, re_c+1, im_c+1)) for rows r0 + g + 8 hh and even
// columns c0 + 8 jt + 2t.
template <class Epi>
__device__ __forceinline__ void each_pair(const float (&are)[kTiles][4],
                                          const float (&aim)[kTiles][4], int r0, int c0,
                                          Epi&& epi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jt = 0; jt < kTiles; ++jt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      epi(r0 + g + 8 * hh, c0 + 8 * jt + 2 * t,
          make_float4(are[jt][2 * hh], aim[jt][2 * hh], are[jt][2 * hh + 1], aim[jt][2 * hh + 1]));
}

// The (re, im) words of the bf16-rounded pair b0, b1 (two neighbouring
// columns), stored at the swizzled offset o of a pair of planes.
__device__ __forceinline__ void store_pair(__nv_bfloat16* re, int o, float2 b0, float2 b1) {
  *reinterpret_cast<uint32_t*>(re + o) = tc::pack_bf16(b0.x, b1.x);
  *reinterpret_cast<uint32_t*>(re + kPlane + o) = tc::pack_bf16(b0.y, b1.y);
}

// Row block p (this CTA's rank) of a matrix whose strips the four CTAs hold
// at `strip` (the same offset in each CTA's shared memory), into the local
// row block `block`: 64 x 64 from each rank, 16 bytes a copy.
__device__ __forceinline__ void gather_rows(__nv_bfloat16* strip, __nv_bfloat16* block) {
  cg::cluster_group cluster = cg::this_cluster();
  const int p = static_cast<int>(cluster.block_rank());
  constexpr int kChunks = kRanks * kPart * (kPart / 8);   // 16-byte chunks a plane
  for (int i = threadIdx.x; i < 2 * kChunks; i += kThreads) {
    const int plane = i / kChunks, rem = i % kChunks;
    const int q = rem / (kPart * kPart / 8);
    const int row = (rem / (kPart / 8)) % kPart;
    const int ch = rem % (kPart / 8);
    const __nv_bfloat16* src = cluster.map_shared_rank(strip, q) + plane * kPlane;
    *reinterpret_cast<uint4*>(block + plane * kPlane + tc::swz<kM>(row, kPart * q + 8 * ch)) =
        *reinterpret_cast<const uint4*>(src + tc::swz<kPart>(kPart * p + row, 8 * ch));
  }
}

// Strip q (this CTA's rank) of a matrix whose row blocks the four CTAs hold
// at `block`, into the local strip `strip`: 64 x 64 from each rank.
__device__ __forceinline__ void gather_strip(__nv_bfloat16* block, __nv_bfloat16* strip) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  constexpr int kChunks = kRanks * kPart * (kPart / 8);
  for (int i = threadIdx.x; i < 2 * kChunks; i += kThreads) {
    const int plane = i / kChunks, rem = i % kChunks;
    const int p = rem / (kPart * kPart / 8);
    const int row = (rem / (kPart / 8)) % kPart;
    const int ch = rem % (kPart / 8);
    const __nv_bfloat16* src = cluster.map_shared_rank(block, p) + plane * kPlane;
    *reinterpret_cast<uint4*>(strip + plane * kPlane + tc::swz<kPart>(kPart * p + row, 8 * ch)) =
        *reinterpret_cast<const uint4*>(src + tc::swz<kM>(row, kPart * q + 8 * ch));
  }
}

// The sum over the cluster of each rank's part[i], i < n, taken in rank
// order, so every CTA gets the same value.
template <int n>
__device__ __forceinline__ void cluster_sum(float* part, float (&v)[n]) {
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = 0.f;
#pragma unroll
  for (int r = 0; r < kRanks; ++r) {
    const float* rp = cluster.map_shared_rank(part, r);
#pragma unroll
    for (int i = 0; i < n; ++i) v[i] += rp[i];
  }
}

// --- Loaders: strip q of a window, or row block p of a spectrum, into
// swizzled bf16 planes at `dst` (re, then im kPlane elements on), every
// thread of the CTA, all of a thread's loads in flight at once. A window's
// rows n2 < m/2 come from the block `top`, the others from the same
// channel's next block, `next` elements on.

// The i8 window (int8 blocks [m/2, 2m]): strip q is 128 contiguous bytes of
// each row n2. A = bf16(float(i8) * (1/127)), as load_window_i8 rounds.
struct StripI8 {
  const int8_t* __restrict__ top;
  size_t next;

  __device__ __forceinline__ void operator()(int q, __nv_bfloat16* dst) const {
    constexpr float kScale = static_cast<float>(1.0 / 127.0);
    constexpr int kRowChunks = kPart / 8;                   // 16-byte vectors of a row's strip
    constexpr int kSteps = kM * kRowChunks / kThreads;
    static_assert(kM * kRowChunks % kThreads == 0, "whole rounds only");
    int4 v[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int w = threadIdx.x + u * kThreads;
      const int row = w / kRowChunks, ch = w % kRowChunks;
      const int8_t* src = top + (row >= kM / 2 ? next : 0) +
                          static_cast<size_t>(row % (kM / 2)) * (2 * kM) + q * (2 * kPart) + 16 * ch;
      v[u] = __ldg(reinterpret_cast<const int4*>(src));
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int w = threadIdx.x + u * kThreads;
      const int row = w / kRowChunks, ch = w % kRowChunks;
      const int words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      uint32_t re[4], im[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        re[j] = tc::pack_bf16(sbyte(words[j], 0) * kScale, sbyte(words[j], 2) * kScale);
        im[j] = tc::pack_bf16(sbyte(words[j], 1) * kScale, sbyte(words[j], 3) * kScale);
      }
      const int o = tc::swz<kPart>(row, 8 * ch);
      *reinterpret_cast<uint4*>(dst + o) = make_uint4(re[0], re[1], re[2], re[3]);
      *reinterpret_cast<uint4*>(dst + kPlane + o) = make_uint4(im[0], im[1], im[2], im[3]);
    }
  }
};

// The float path's window (bf16 block planes re, im [m/2, m]): strip q is
// 128 contiguous bytes of each row n2 of each plane, stored as loaded (the
// strip form of load_window_planes).
struct StripPlanes {
  const __nv_bfloat16* __restrict__ re;
  const __nv_bfloat16* __restrict__ im;
  size_t next;

  __device__ __forceinline__ void operator()(int q, __nv_bfloat16* dst) const {
    constexpr int kRowChunks = kPart / 8;
    constexpr int kSteps = kM * kRowChunks / kThreads;
    static_assert(kM * kRowChunks % kThreads == 0, "whole rounds only");
    uint4 vr[kSteps], vi[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int w = threadIdx.x + u * kThreads;
      const int row = w / kRowChunks, ch = w % kRowChunks;
      const size_t o = (row >= kM / 2 ? next : 0) + static_cast<size_t>(row % (kM / 2)) * kM +
                       q * kPart + 8 * ch;
      vr[u] = __ldg(reinterpret_cast<const uint4*>(re + o));
      vi[u] = __ldg(reinterpret_cast<const uint4*>(im + o));
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int w = threadIdx.x + u * kThreads;
      const int o = tc::swz<kPart>(w / kRowChunks, 8 * (w % kRowChunks));
      *reinterpret_cast<uint4*>(dst + o) = vr[u];
      *reinterpret_cast<uint4*>(dst + kPlane + o) = vi[u];
    }
  }
};

// Eight complex64 values (four float4: re, im, re, im) rounded to bf16 into
// one 16-byte chunk of each plane at offset o.
__device__ __forceinline__ void store_c64_chunk(const float4 (&v)[4], __nv_bfloat16* dst, int o) {
  uint32_t re[4], im[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    re[j] = tc::pack_bf16(v[j].x, v[j].z);
    im[j] = tc::pack_bf16(v[j].y, v[j].w);
  }
  *reinterpret_cast<uint4*>(dst + o) = make_uint4(re[0], re[1], re[2], re[3]);
  *reinterpret_cast<uint4*>(dst + kPlane + o) = make_uint4(im[0], im[1], im[2], im[3]);
}

// A complex64 matrix x [m][m] (the four-step's input, row n2 holding
// samples n1): strip q is 512 contiguous bytes of each row. A = bf16(x).
struct StripC64 {
  const float2* __restrict__ x;

  __device__ __forceinline__ void operator()(int q, __nv_bfloat16* dst) const {
    constexpr int kRowChunks = kPart / 8;                   // 8-element chunks of a row's strip
    constexpr int kSteps = kM * kRowChunks / kThreads;
    static_assert(kM * kRowChunks % kThreads == 0, "whole rounds only");
    float4 v[kSteps][4];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int w = threadIdx.x + u * kThreads;
      const float4* src = reinterpret_cast<const float4*>(
          x + (w / kRowChunks) * kM + q * kPart + 8 * (w % kRowChunks));
#pragma unroll
      for (int j = 0; j < 4; ++j) v[u][j] = __ldcs(src + j);
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int w = threadIdx.x + u * kThreads;
      store_c64_chunk(v[u], dst, tc::swz<kPart>(w / kRowChunks, 8 * (w % kRowChunks)));
    }
  }
};

// Row block p of a complex64 permuted spectrum X [m][m] (k2, k1): 64
// contiguous rows of 2 kB. G = bf16(X).
__device__ __forceinline__ void load_block_c64(const float2* __restrict__ X, int p,
                                               __nv_bfloat16* dst) {
  constexpr int kRowChunks = kM / 8;
  constexpr int kSteps = kPart * kRowChunks / kThreads;
  static_assert(kPart * kRowChunks % kThreads == 0, "whole rounds only");
  float4 v[kSteps][4];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int w = threadIdx.x + u * kThreads;
    const float4* src = reinterpret_cast<const float4*>(X + static_cast<size_t>(kPart) * p * kM +
                                                        8 * w);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[u][j] = __ldcs(src + j);
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int w = threadIdx.x + u * kThreads;
    store_c64_chunk(v[u], dst, tc::swz<kM>(w / kRowChunks, 8 * (w % kRowChunks)));
  }
}

// The forward four-step of a window on the cluster, this CTA rank p:
// load(p, X) puts strip p of the window into X; C = bf16((F A) * T) on
// strip p into Y; a cluster barrier; row block p of C gathered into X; a
// cluster barrier (after which no CTA reads another's shared memory); then
// D = C F on row block p, each finished pair of D handed to epi(r, c,
// float4(re_c, im_c, re_c+1, im_c+1)) with r the row within the block (k2 =
// 64 p + r) and c the column k1. X, Y: kBuf bytes each. The epilogue may
// write Y and beyond, but not X, which the other warps still read.
template <class Load, class Epi>
__device__ __forceinline__ void forward_cluster(const Load& load, const float2* __restrict__ F,
                                                const float2* __restrict__ Tw,
                                                __nv_bfloat16* X, __nv_bfloat16* Y, Epi&& epi) {
  cg::cluster_group cluster = cg::this_cluster();
  const int p = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5;
  load(p, X);
  __syncthreads();
  // Strip p of C: 16 row tiles x 2 column tiles of 16 x 32.
  for (int tile = warp; tile < (kM / 16) * (kPart / tc::kChunk); tile += kWarps) {
    const int r0 = 16 * (tile / (kPart / tc::kChunk));
    const int c0 = tc::kChunk * (tile % (kPart / tc::kChunk));
    float are[kTiles][4], aim[kTiles][4];
    table_x_strip(F, r0, X, X + kPlane, c0, are, aim);
    each_pair(are, aim, r0, c0, [&](int r, int c, float4 b) {
      const float4 tw = __ldg(reinterpret_cast<const float4*>(Tw + r * kM + kPart * p + c));
      store_pair(Y, tc::swz<kPart>(r, c), tc::twiddle<false>(b.x, b.y, tw.x, tw.y),
                 tc::twiddle<false>(b.z, b.w, tw.z, tw.w));
    });
  }
  cluster.sync();   // every strip of C complete; every window strip read
  gather_rows(Y, X);
  cluster.sync();   // every row block gathered: no more remote reads
  // Row block p of D: 4 row tiles x 8 column tiles.
  for (int tile = warp; tile < (kPart / 16) * (kM / tc::kChunk); tile += kWarps) {
    const int r0 = 16 * (tile % (kPart / 16));
    const int c0 = tc::kChunk * (tile / (kPart / 16));
    float dre[kTiles][4], dim[kTiles][4];
    block_x_table(X, X + kPlane, r0, F, c0, dre, dim);
    each_pair(dre, dim, r0, c0, epi);
  }
}

// The inverse four-step of a permuted spectrum on the cluster, this CTA
// rank p, from row block p of G (k2 in [64 p, 64 p + 64), complete at `g`):
// C2 = G Fi on it, B2 = bf16(C2 * conj(T)) into `b`; a cluster barrier;
// strip p of B2 (columns n1 in [64 p, 64 p + 64), every row k2) gathered
// into `g`; a cluster barrier (after which no CTA reads another's shared
// memory); then the rows n2 in [R0, R0 + NROWS) of y = Fi B2 on strip p,
// each finished pair handed to epi(n2, c, float4(re_c, im_c, re_c+1,
// im_c+1)) with c the column within the strip (n1 = 64 p + c). The
// overlap-save applies keep the centre rows [m/4, 3m/4), the four-step
// all of them. g, b: kBuf bytes each.
template <int R0, int NROWS, class Epi>
__device__ __forceinline__ void inverse_cluster(const float2* __restrict__ Fi,
                                                const float2* __restrict__ Tw, __nv_bfloat16* g,
                                                __nv_bfloat16* b, Epi&& epi) {
  static_assert(R0 % 16 == 0 && NROWS % 16 == 0 && R0 + NROWS <= kM, "whole row tiles");
  cg::cluster_group cluster = cg::this_cluster();
  const int p = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5;
  // Row block p of B2: 4 row tiles x 8 column tiles.
  for (int tile = warp; tile < (kPart / 16) * (kM / tc::kChunk); tile += kWarps) {
    const int r0 = 16 * (tile % (kPart / 16));
    const int c0 = tc::kChunk * (tile / (kPart / 16));
    float are[kTiles][4], aim[kTiles][4];
    block_x_table(g, g + kPlane, r0, Fi, c0, are, aim);
    each_pair(are, aim, r0, c0, [&](int r, int c, float4 v) {
      const float4 tw = __ldg(reinterpret_cast<const float4*>(Tw + (kPart * p + r) * kM + c));
      store_pair(b, tc::swz<kM>(r, c), tc::twiddle<true>(v.x, v.y, tw.x, tw.y),
                 tc::twiddle<true>(v.z, v.w, tw.z, tw.w));
    });
  }
  cluster.sync();   // every row block of B2 complete; G read
  gather_strip(b, g);
  cluster.sync();   // every strip gathered: no more remote reads
  // Rows [R0, R0 + NROWS) of y on strip p: NROWS / 16 row tiles x 2 column tiles.
  for (int tile = warp; tile < (NROWS / 16) * (kPart / tc::kChunk); tile += kWarps) {
    const int r0 = R0 + 16 * (tile / (kPart / tc::kChunk));
    const int c0 = tc::kChunk * (tile % (kPart / tc::kChunk));
    float yre[kTiles][4], yim[kTiles][4];
    table_x_strip(Fi, r0, g, g + kPlane, c0, yre, yim);
    each_pair(yre, yim, r0, c0, epi);
  }
}

}  // namespace cl
}  // namespace fused
