// The m = 256 (W = 65536, L = 32768) kernels run a window on a thread-block
// cluster of four CTAs: every measure kernel (fused_measure.cu:
// measure_ref_cluster_kernel, measure_cluster_kernel,
// measure_planes_cluster_kernel), every apply kernel (fused_apply.cu:
// apply_spec_cluster_kernel, apply_i8_cluster_kernel,
// apply_planes_cluster_kernel) and the four-step FFT (fourstep.cu:
// fourstep_cluster_kernel). This header holds what they share: the table
// ring, the products, the strip and row-block loaders of each input format,
// the forward transform and the inverse.
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
//
// The tables through shared memory (Ring). Every product multiplies by F or
// Fi (symmetric) over its whole k = 256, and all four CTAs read the same
// table in the same order. The host packs F and Fi once as bf16 k-slices
// (kernels/fused.py:cluster_slices): slice s holds rows 0..255, k in
// [16 s, 16 s + 16), re then im, each plane in 8 x 8 core matrices of 128
// contiguous bytes, (n / 8, k / 8) at 2 (n / 8) + k / 8: the layout that
// wgmma's K-major, unswizzled descriptor names (leading byte offset 128,
// stride 256). A ring of kStages slots of 16 kB streams the slices: rank
// 0's thread 0
// copies each slice once from L2 into all four CTAs (cp.async.bulk with
// .multicast::cluster), completing on each CTA's "full" mbarrier, which
// that CTA's thread 0 arms with the slice's bytes; every warp of every CTA
// releases a slot on rank 0's "empty" mbarrier (a remote arrive, 64 a
// phase), and rank 0 refills the slot only once that phase is complete.
// The barriers are initialised and fenced, and the cluster synchronised,
// before the first copy. One L2 read a slice feeds the cluster: 1 MB of
// table a window against ~12.5 MB when each CTA read its table operand
// from L2 into mma fragments, as these kernels did before the ring.
//
// The products. Each takes its table operand as B (k x n, stored [n][k]:
// the slice, read by wgmma through a descriptor) and the window's operand
// as A from registers: the CTA's 16 warps are four warpgroups, each
// computes a 64 x 64 tile (its 64 columns of n) with wgmma m64n64k16 (n32
// for the applies' 128 centre rows), each warp 16 rows of A (ldmatrix,
// transposed where the operand is stored [k][row]), each complex product
// as four real bf16 products with float32 sums (re = Ar Br - Ai Bi, im =
// Ar Bi + Ai Br; -Ai by wgmma's scale on A). One slice's products stay in
// flight while the next slice's fragments load and its products issue
// (ring_product's PIPE; apply_i8_cluster_kernel, which would spill with
// two fragment sets, waits for each slice instead). A forward transform
// D = (F A * T) F is then, on CTA rank p: B^T = A^T F on strip p of the
// window (A^T read transposed from the strip), C^T = bf16(B^T * T^T)
// stored [n1][k2] (T is symmetric); a cluster barrier; the strips gathered
// into C's row block p, stored transposed [n1][k2 - 64 p]; a cluster
// barrier; D = C F on row block p (forward_cluster). The inverse
// (inverse_cluster): C2 = G Fi on row block p of G, B2 = bf16(C2 *
// conj(T)); a cluster barrier; strip p of B2 gathered; a cluster barrier;
// y^T = B2^T Fi on strip p, whose rows n1 come out in pairs along n2 and
// are turned into pairs along n1 by one exchange between neighbouring
// lanes. Every kernel keeps to 128 registers a thread (512 threads, one
// CTA an SM) with no spill: the epilogues' index math is kept after the
// products (opaque), and the measure stages D through shared memory.
//
// What bounds them (tools/time_cluster.py on the H100, 1,323 windows; the
// numbers in PERF.md). The table operand from L2 bounded the kernels before the ring:
// the ring alone (step one, mma.sync still reading A and B through
// ldmatrix) took the forward four-step from 2.05-2.11 ms to 1.52-1.55,
// wgmma to 1.21-1.26. Now neither the table nor the tensor cores bound
// them: with no products at all (the ring still streaming) the forward
// takes 0.98-1.03 ms, without the ring too 0.79-0.81, against 0.41 ms for
// its bytes. What is left is the window's serial path on its cluster, one
// CTA an SM with nothing to overlap it: the strip's load, the twiddle from
// L2 (float32, 128 kB a CTA), two exchanges between cluster barriers, the
// stores, the ring's start. A persistent cluster that loads the next
// window while this one computes is the next step. Both operands from
// shared memory (A through a 128-byte-swizzled descriptor, the row blocks
// in four 64-column tiles) ran no faster (1.31 ms) and read twice the
// shared memory: A stays in registers.

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
constexpr int kThreads = 512;         // 16 warps, four warpgroups, a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kPlane = kM * kPart;    // bf16 elements of one plane of a strip or row block
constexpr size_t kBuf = 2 * kPlane * sizeof(__nv_bfloat16);   // a strip or row block, 64 kB

// --- The table ring.
constexpr int kK = 16;                          // k of a slice (one k step)
constexpr int kSlices = kM / kK;                // slices a product
constexpr int kSliceElems = 2 * kM * kK;        // bf16 elements of a slice (re, im)
constexpr uint32_t kSliceBytes = kSliceElems * sizeof(__nv_bfloat16);   // 16 kB
constexpr int kStages = 4;                      // slots of the ring
constexpr size_t kRingBytes = kStages * static_cast<size_t>(kSliceBytes);   // 64 kB
constexpr size_t kRingBarBytes = 2 * kStages * sizeof(uint64_t) + 2 * sizeof(void*);
constexpr uint16_t kAllRanks = (1u << kRanks) - 1;   // the multicast mask

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival on this CTA's barrier, which then also expects `bytes` more.
__device__ __forceinline__ void mbar_arm(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of the barrier with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = tc::smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One arrival on the barrier at the same offset in the shared memory of
// cluster rank `rank`.
__device__ __forceinline__ void mbar_arrive_rank(uint64_t* bar, int rank) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(tc::smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// `bytes` from device memory into the same offset `dst` of the shared
// memory of every CTA of the cluster, completing on each one's barrier at
// the offset of `bar`.
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(tc::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(tc::smem_addr(bar)), "h"(kAllRanks)
      : "memory");
}

// The ring of one kernel: the slices of TRANSFORMS transforms, 2 kSlices
// each (both products read the whole table), from the first table for the
// first transform and the second for the second; the slots at byte SLOTS
// of the dynamic shared memory and the barriers and the two table pointers
// at BARS, the same offsets in every CTA. Use: start() once, by every
// thread, before any other cluster barrier; then per slice j wait(j), read
// the slot, release(j). A kernel ends with a cluster barrier after its last
// slice, so that no CTA leaves while rank 0's copies into the others may be
// in flight. Every address is a constant offset of the shared memory and
// the count of slices a constant: a thread keeps no state of its own.
template <size_t SLOTS, size_t BARS, int TRANSFORMS>
struct Ring {
  static constexpr int kTotal = 2 * kSlices * TRANSFORMS;

  static __device__ __forceinline__ unsigned char* base() {
    extern __shared__ __align__(128) unsigned char dyn_smem[];
    return dyn_smem;
  }
  static __device__ __forceinline__ __nv_bfloat16* slot(int s) {
    return reinterpret_cast<__nv_bfloat16*>(base() + SLOTS) + s * kSliceElems;
  }
  // full(s): the slice has landed in this CTA; empty(s), used on rank 0:
  // every warp of the cluster released the slot.
  static __device__ __forceinline__ uint64_t* full(int s) {
    return reinterpret_cast<uint64_t*>(base() + BARS) + s;
  }
  static __device__ __forceinline__ uint64_t* empty(int s) { return full(kStages + s); }
  static __device__ __forceinline__ const __nv_bfloat16** tables() {
    return reinterpret_cast<const __nv_bfloat16**>(full(2 * kStages));
  }
  static __device__ __forceinline__ int rank() {
    return static_cast<int>(cg::this_cluster().block_rank());
  }

  static __device__ __forceinline__ void issue(int j) {
    const int s = j % kStages;
    const __nv_bfloat16* tab = tables()[j < 2 * kSlices ? 0 : 1];
    bulk_multicast(slot(s), tab + (j % kSlices) * kSliceElems, kSliceBytes, full(s));
  }

  static __device__ __forceinline__ void start(const __nv_bfloat16* t0, const __nv_bfloat16* t1) {
    constexpr int first = kTotal < kStages ? kTotal : kStages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), kRanks * kWarps);
      }
      tables()[0] = t0;
      tables()[1] = t1;
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int s = 0; s < first; ++s) mbar_arm(full(s), kSliceBytes);
    }
    cg::this_cluster().sync();   // every CTA's barriers ready before any copy lands
    if (rank() == 0 && threadIdx.x == 0)
      for (int j = 0; j < first; ++j) issue(j);
  }

  // The slot of slice j, once it has landed.
  static __device__ __forceinline__ const __nv_bfloat16* wait(int j) {
    mbar_wait(full(j % kStages), (j / kStages) & 1);
    return slot(j % kStages);
  }

  // This warp is done with the slot of slice j: release it to rank 0, arm
  // it for its refill and, on rank 0, refill it once every warp of the
  // cluster has released it.
  static __device__ __forceinline__ void release(int j) {
    if (j + kStages < kTotal) {
      const int s = j % kStages;
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive_rank(empty(s), 0);
      if (threadIdx.x == 0) {
        mbar_arm(full(s), kSliceBytes);
        if (rank() == 0) {
          mbar_wait(empty(s), (j / kStages) & 1);
          issue(j + kStages);
        }
      }
      __syncwarp();
    }
  }
};

// acc += A B for one slice, on this warpgroup's 64 x N tile: A (ar, ai)
// this warp's 16 rows x the slice's 16 k, from registers; B the slice's
// rows n0..n0+N-1 (n) and its 16 k, read by wgmma through K-major
// descriptors (leading byte offset 128: the next 8 k; stride 256: the next
// 8 rows). re += Ar Br - Ai Bi, im += Ar Bi + Ai Br: four wgmma, issued
// and committed, not waited for.
template <int N>
__device__ __forceinline__ void slice_product(const __nv_bfloat16* slot, int n0,
                                              const uint32_t (&ar)[4], const uint32_t (&ai)[4],
                                              float (&re)[N / 8][4], float (&im)[N / 8][4]) {
  const uint64_t bre = tc::desc_k(slot + n0 * kK, 128, 256);
  const uint64_t bim = tc::desc_k(slot + kM * kK + n0 * kK, 128, 256);
  tc::wgmma_fence();
  tc::wgmma<N, 1>(re, ar, bre);
  tc::wgmma<N, -1>(re, ai, bim);
  tc::wgmma<N, 1>(im, ar, bim);
  tc::wgmma<N, 1>(im, ai, bre);
  tc::wgmma_commit();
}

// acc = A T over k = 0..255, T the ring's slices j0 .. j0 + kSlices - 1:
// this warpgroup's 64 x N tile at columns n0 (the table's rows), this
// warp's rows wr..wr+15 of A, whose fragments a_frag(wr, k0, ar, ai) loads.
// PIPE: one slice's products stay in flight while the next slice's A
// fragments load (two fragment sets) and its products issue; a slice is
// released once its products are done. Without PIPE each slice's products
// are waited for before the next begins: eight registers fewer, for a
// kernel that would otherwise spill (apply_i8_cluster_kernel).
template <int N, class R, bool PIPE, class AFrag>
__device__ __forceinline__ void ring_product(int j0, int wr, int n0, const AFrag& a_frag,
                                             float (&re)[N / 8][4], float (&im)[N / 8][4]) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) re[i][e] = im[i][e] = 0.f;
  if constexpr (PIPE) {
    uint32_t ar[2][4], ai[2][4];
#pragma unroll 1
    for (int ks = 0; ks < kSlices; ks += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a_frag(wr, kK * (ks + h), ar[h], ai[h]);
        slice_product<N>(R::wait(j0 + ks + h), n0, ar[h], ai[h], re, im);
        tc::wgmma_wait<1>();   // the previous slice's products are done
        if (ks + h > 0) R::release(j0 + ks + h - 1);
      }
    }
    tc::wgmma_wait<0>();
    R::release(j0 + kSlices - 1);
  } else {
#pragma unroll 1
    for (int ks = 0; ks < kSlices; ++ks) {
      uint32_t ar[4], ai[4];
      a_frag(wr, kK * ks, ar, ai);
      slice_product<N>(R::wait(j0 + ks), n0, ar, ai, re, im);
      tc::wgmma_wait<0>();
      R::release(j0 + ks);
    }
  }
}

// v, hidden from the optimizer behind an empty volatile asm, which stays
// after the products' (volatile) wgmma: index math that derives from it is
// computed where it is used, in an epilogue, rather than hoisted above the
// product loop, where it would hold registers beside the accumulators.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// Each pair of finished elements of a warp's 16 x N tile at (r0, c0):
// epi(r, c, float4(re_c, im_c, re_c+1, im_c+1)) for rows r0 + g + 8 hh and
// even columns c0 + 8 jt + 2t.
template <int NT, class Epi>
__device__ __forceinline__ void each_pair(const float (&are)[NT][4], const float (&aim)[NT][4],
                                          int r0, int c0, Epi&& epi) {
  const int lane = opaque(threadIdx.x & 31);
  const int g = lane >> 2, t = lane & 3;
  r0 = opaque(r0);
  c0 = opaque(c0);
#pragma unroll
  for (int jt = 0; jt < NT; ++jt)
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

// Strip q (this CTA's rank) of a matrix whose row blocks the four CTAs hold
// at `block`, into the local strip `strip`: 64 x 64 from each rank, 16
// bytes a copy, all of a thread's remote loads in flight at once. (With
// both stored transposed, it gathers row block q of a matrix from its
// strips.)
__device__ __forceinline__ void gather_strip(__nv_bfloat16* block, __nv_bfloat16* strip) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  constexpr int kChunks = kRanks * kPart * (kPart / 8);   // 16-byte chunks a plane
  constexpr int kSteps = 2 * kChunks / kThreads;
  static_assert(2 * kChunks % kThreads == 0, "whole rounds only");
  uint4 v[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int plane = i / kChunks, rem = i % kChunks;
    const int p = rem / (kPart * kPart / 8);
    const int row = (rem / (kPart / 8)) % kPart;
    const int ch = rem % (kPart / 8);
    const __nv_bfloat16* src = cluster.map_shared_rank(block, p) + plane * kPlane;
    v[u] = *reinterpret_cast<const uint4*>(src + tc::swz<kM>(row, kPart * q + 8 * ch));
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int plane = i / kChunks, rem = i % kChunks;
    const int p = rem / (kPart * kPart / 8);
    const int row = (rem / (kPart / 8)) % kPart;
    const int ch = rem % (kPart / 8);
    *reinterpret_cast<uint4*>(strip + plane * kPlane + tc::swz<kPart>(kPart * p + row, 8 * ch)) =
        v[u];
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
    // Two rounds of loads: all of a thread's 16 float4 in flight at once
    // made the four-step's forward spill.
    constexpr int kRowChunks = kPart / 8;                   // 8-element chunks of a row's strip
    constexpr int kSteps = kM * kRowChunks / kThreads / 2;  // each of two rounds
    static_assert(kM * kRowChunks % (2 * kThreads) == 0, "whole rounds only");
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float4 v[kSteps][4];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int w = threadIdx.x + (half * kSteps + u) * kThreads;
        const float4* src = reinterpret_cast<const float4*>(
            x + (w / kRowChunks) * kM + q * kPart + 8 * (w % kRowChunks));
#pragma unroll
        for (int j = 0; j < 4; ++j) v[u][j] = __ldcs(src + j);
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int w = threadIdx.x + (half * kSteps + u) * kThreads;
        store_c64_chunk(v[u], dst, tc::swz<kPart>(w / kRowChunks, 8 * (w % kRowChunks)));
      }
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

// The A fragments (re, im planes kPlane apart) of a window operand stored
// [k][row] (a strip, or a row block held transposed), or [row][k] (a row
// block, 256 columns).
struct ATrans {
  const __nv_bfloat16* s;
  __device__ __forceinline__ void operator()(int r0, int k0, uint32_t (&ar)[4],
                                             uint32_t (&ai)[4]) const {
    tc::ldsm_a_trans<kPart>(s, r0, k0, ar);
    tc::ldsm_a_trans<kPart>(s + kPlane, r0, k0, ai);
  }
};

struct ARows {
  const __nv_bfloat16* s;
  __device__ __forceinline__ void operator()(int r0, int k0, uint32_t (&ar)[4],
                                             uint32_t (&ai)[4]) const {
    tc::ldsm_a<kM>(s, r0, k0, ar);
    tc::ldsm_a<kM>(s + kPlane, r0, k0, ai);
  }
};

// The forward four-step of a window on the cluster, this CTA rank p, the
// ring's next 2 kSlices slices holding F: load(p, X) puts strip p of the
// window into X; C^T = bf16((A^T F) * T^T) on strip p into Y ([n1][k2]); a
// cluster barrier; C's row block p gathered into X, transposed ([n1][k2 -
// 64 p]); a cluster barrier (after which no CTA reads another's shared
// memory); then D = C F on row block p, each finished pair of D handed to
// epi(r, c, float4(re_c, im_c, re_c+1, im_c+1)) with r the row within the
// block (k2 = 64 p + r) and c the column k1, once every warp is done with
// the ring. X, Y: kBuf bytes each. The epilogue may write Y and beyond (the
// ring's slots too), but not X, which the other warps still read.
template <class R, bool PIPE = true, class Load, class Epi>
__device__ __forceinline__ void forward_cluster(const Load& load, int j0,
                                                const float2* __restrict__ Tw,
                                                __nv_bfloat16* X, __nv_bfloat16* Y, Epi&& epi) {
  cg::cluster_group cluster = cg::this_cluster();
  const int p = R::rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * (warp & 3);        // this warp's rows of its warpgroup's tile
  const int n0 = kPart * (warp >> 2);    // the warpgroup's columns
  load(p, X);
  __syncthreads();
  {
    // B^T[n1][k2] on strip p: rows n1 = 64 p + wr + g + 8 hh, columns k2.
    float re[kPart / 8][4], im[kPart / 8][4];
    ring_product<kPart, R, PIPE>(j0, wr, n0, ATrans{X}, re, im);
    const int r0 = opaque(wr + g), c0 = opaque(n0 + 2 * t);
#pragma unroll
    for (int jt = 0; jt < kPart / 8; ++jt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = r0 + 8 * hh, k2 = c0 + 8 * jt;
        const float4 tw = __ldg(reinterpret_cast<const float4*>(Tw + (kPart * p + n) * kM + k2));
        store_pair(Y, tc::swz<kM>(n, k2),
                   tc::twiddle<false>(re[jt][2 * hh], im[jt][2 * hh], tw.x, tw.y),
                   tc::twiddle<false>(re[jt][2 * hh + 1], im[jt][2 * hh + 1], tw.z, tw.w));
      }
  }
  cluster.sync();   // every strip of C^T complete; every window strip read
  gather_strip(Y, X);
  cluster.sync();   // C's row block gathered: no more remote reads
  float dre[kPart / 8][4], dim[kPart / 8][4];
  ring_product<kPart, R, PIPE>(j0 + kSlices, wr, n0, ATrans{X}, dre, dim);
  __syncthreads();  // every warp done with the ring's slots
  each_pair(dre, dim, wr, n0, epi);
}

// The inverse four-step of a permuted spectrum on the cluster, this CTA
// rank p, the ring's next 2 kSlices slices holding Fi, from row block p of
// G (k2 in [64 p, 64 p + 64), complete at `g`): C2 = G Fi on it, B2 =
// bf16(C2 * conj(T)) into `b`; a cluster barrier; strip p of B2 (columns n1
// in [64 p, 64 p + 64), every row k2) gathered into `g`; a cluster barrier
// (after which no CTA reads another's shared memory); then the rows n2 in
// [R0, R0 + NROWS) of y = Fi B2 on strip p, as y^T = B2^T Fi (each
// warpgroup NROWS / 4 of them), each finished pair handed to epi(n2, c,
// float4(re_c, im_c, re_c+1, im_c+1)) with c the column within the strip
// (n1 = 64 p + c); a closing cluster barrier. The overlap-save applies keep
// the centre rows [m/4, 3m/4), the four-step all of them. g, b: kBuf bytes
// each.
template <class R, int R0, int NROWS, bool PIPE = true, class Epi>
__device__ __forceinline__ void inverse_cluster(int j0, const float2* __restrict__ Tw,
                                                __nv_bfloat16* g, __nv_bfloat16* b, Epi&& epi) {
  static_assert(R0 % 8 == 0 && NROWS % 64 == 0 && R0 + NROWS <= kM, "whole n8 tiles a warpgroup");
  constexpr int N = NROWS / 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int p = R::rank();
  const int warp = threadIdx.x >> 5;
  const int wr = 16 * (warp & 3);
  {
    // Row block p of B2: rows k2 = 64 p + wr + g + 8 hh (g = lane / 4),
    // columns n1.
    const int n0 = kPart * (warp >> 2);
    float re[kPart / 8][4], im[kPart / 8][4];
    ring_product<kPart, R, PIPE>(j0, wr, n0, ARows{g}, re, im);
    each_pair(re, im, wr, n0, [&](int r, int c, float4 v) {
      const float4 tw = __ldg(reinterpret_cast<const float4*>(Tw + (kPart * p + r) * kM + c));
      store_pair(b, tc::swz<kM>(r, c), tc::twiddle<true>(v.x, v.y, tw.x, tw.y),
                 tc::twiddle<true>(v.z, v.w, tw.z, tw.w));
    });
  }
  cluster.sync();   // every row block of B2 complete; G read
  gather_strip(b, g);
  cluster.sync();   // every strip gathered: no more remote reads
  // y^T on strip p: rows n1 = 64 p + wr + g + 8 hh, columns n2 = n0 + 8 jt
  // + 2t + e. Lanes g and g ^ 1 trade halves so that each holds a pair
  // along n1 (the even one at n2 = n0 + 8 jt + 2t, the odd one at + 1).
  const int n0 = R0 + N * (warp >> 2);
  float yre[N / 8][4], yim[N / 8][4];
  ring_product<N, R, PIPE>(j0 + kSlices, wr, n0, ATrans{g}, yre, yim);
  const int lane = opaque(threadIdx.x & 31);
  const bool odd = (lane >> 2) & 1;
  const int c0 = opaque(n0 + 2 * (lane & 3) + (odd ? 1 : 0));
  const int r0 = opaque(wr + ((lane >> 2) & ~1));
#pragma unroll
  for (int jt = 0; jt < N / 8; ++jt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 v0 = make_float2(yre[jt][2 * hh], yim[jt][2 * hh]);
      const float2 v1 = make_float2(yre[jt][2 * hh + 1], yim[jt][2 * hh + 1]);
      const float2 send = odd ? v0 : v1;
      const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 4),
                                     __shfl_xor_sync(0xffffffffu, send.y, 4));
      const float2 lo = odd ? got : v0, hi = odd ? v1 : got;
      epi(c0 + 8 * jt, r0 + 8 * hh, make_float4(lo.x, lo.y, hi.x, hi.y));
    }
  cluster.sync();   // no CTA leaves while the ring's last copies may be in flight
}

}  // namespace cl
}  // namespace fused
