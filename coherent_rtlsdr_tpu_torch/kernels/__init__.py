"""The four-step FFT (plain products and the CUDA kernel), the fused
measure/apply kernels, the block copy of the roofline probe, the
permuted-layout ops and the spectral backends.
The CUDA sources are in ``csrc/``, bound in ``kernels/fused_cuda.py``."""

from coherent_rtlsdr_tpu_torch.kernels.backend import (
    FusedSpectral,
    MxuSpectral,
    XlaSpectral,
    get_spectral,
)
from coherent_rtlsdr_tpu_torch.kernels.copy import BlockCopy, get_block_copy
from coherent_rtlsdr_tpu_torch.kernels.fft4step import FFT4Step, supported_fft_len
from coherent_rtlsdr_tpu_torch.kernels.fourstep import FFT4StepKernel, get_fourstep_kernel
from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels, get_fused_kernels

__all__ = ["FFT4Step", "FFT4StepKernel", "supported_fft_len", "FusedPipelineKernels",
           "get_fused_kernels", "get_fourstep_kernel", "XlaSpectral", "MxuSpectral",
           "FusedSpectral", "get_spectral", "BlockCopy", "get_block_copy"]
