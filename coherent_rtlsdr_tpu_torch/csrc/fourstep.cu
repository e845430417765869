// Four-step FFT kernel: one forward or inverse W = m*m point transform per
// CTA, in the permuted (k2, k1) frequency layout of kernels/fft4step.py.
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
// with F and Fi = conj(F)/m bf16-rounded and T float32, so every product
// takes bf16 operands and accumulates in float32, where the Pallas bodies
// cast. The tiled Pallas body stacks `tile` transforms into one MXU product
// to fill the matrix unit; it computes the same function, and here the grid
// over the batch (one CTA per transform, 132 SMs) is that stacking.
//
// Design. Input and output are complex64 [B, m, m] (interleaved float2).
// What bounds it on the H100: by the bytes the function must move (128 kB
// in and 128 kB out a transform at m = 128) it is memory-bound, 78 ns a
// transform at 3.35 TB/s against 34 ns for its 33.6 MFLOP on the bf16
// tensor cores; but this kernel runs the products on the SIMT FMA units
// (two complex m x m x m products, 33.6 MFLOP), so it is compute-bound at
// the FP32 rate. The intermediates stay in shared memory (forward: the
// window as float2 and C as padded bf16, 197,120 bytes at m = 128; inverse:
// G and B as padded bf16, 132,096 bytes). Tensor-core products are later
// work.

#include "fused_common.cuh"

namespace fused {

template <int M, bool INVERSE>
struct FourStepSmem {
  static constexpr size_t kBytes =
      INVERSE ? 2 * SmemBf16Matrix<M>::kBytes : sizeof(float2) * M * M + SmemBf16Matrix<M>::kBytes;
};

// One transform per CTA: x, y complex64 [B, m, m]; tab = F (forward) or Fi
// (inverse), Tw the twiddle, all float2 [m, m].
template <int M, bool INVERSE>
__global__ void __launch_bounds__(kThreads)
fourstep_kernel(const float2* __restrict__ x, const float2* __restrict__ tab,
                const float2* __restrict__ Tw, float2* __restrict__ y) {
  constexpr int W = M * M;
  extern __shared__ __align__(16) unsigned char smem[];
  const float2* xb = x + static_cast<size_t>(blockIdx.x) * W;
  float2* yb = y + static_cast<size_t>(blockIdx.x) * W;

  if constexpr (INVERSE) {
    SmemBf16Matrix<M> G{reinterpret_cast<__nv_bfloat162*>(smem)};
    SmemBf16Matrix<M> B{reinterpret_cast<__nv_bfloat162*>(smem + SmemBf16Matrix<M>::kBytes)};
    for (int i = threadIdx.x; i < W; i += kThreads) {
      const float2 v = xb[i];
      G.set(i / M, i % M, v.x, v.y);
    }
    __syncthreads();
    inverse_fft<M, M>(G, B, tab, Tw, [&](int r, int c, float re, float im) {
      yb[r * M + c] = make_float2(re, im);
    });
  } else {
    float2* A = reinterpret_cast<float2*>(smem);
    SmemBf16Matrix<M> C{reinterpret_cast<__nv_bfloat162*>(smem + sizeof(float2) * M * M)};
    forward_fft<M>(
        [&](float2* a) {
          for (int i = threadIdx.x; i < W; i += kThreads) {
            const float2 v = xb[i];
            a[i] = make_float2(bf16_round(v.x), bf16_round(v.y));
          }
        },
        tab, Tw, A, C, [&](int r, int c, float re, float im) {
          yb[r * M + c] = make_float2(re, im);
        });
  }
}

template <int M, bool INVERSE>
int launch(const void* x, const void* tab, const void* Tw, void* y, int B, void* stream) {
  const int smem = static_cast<int>(FourStepSmem<M, INVERSE>::kBytes);
  const cudaError_t err = set_smem(fourstep_kernel<M, INVERSE>, smem);
  if (err != cudaSuccess) return err;
  fourstep_kernel<M, INVERSE><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(tab),
      static_cast<const float2*>(Tw), static_cast<float2*>(y));
  return cudaGetLastError();
}

}  // namespace fused

// x, y complex64 [B, m, m]; tab = F (inverse = 0) or Fi = conj(F)/m
// (inverse = 1), bf16-rounded, and Tw, all float2 [m, m]. Returns the CUDA
// error code of the launch (0 on success); -1 for an unsupported m.
extern "C" int fourstep_fft(const void* x, const void* tab, const void* Tw, void* y, int B,
                            int m, int inverse, void* stream) {
  switch (m * 2 + (inverse ? 1 : 0)) {
    case 64 * 2:
      return fused::launch<64, false>(x, tab, Tw, y, B, stream);
    case 64 * 2 + 1:
      return fused::launch<64, true>(x, tab, Tw, y, B, stream);
    case 128 * 2:
      return fused::launch<128, false>(x, tab, Tw, y, B, stream);
    case 128 * 2 + 1:
      return fused::launch<128, true>(x, tab, Tw, y, B, stream);
    default:
      return -1;
  }
}
