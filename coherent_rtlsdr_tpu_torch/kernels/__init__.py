"""The four-step FFT and the fused measure/apply pair, with their CUDA
kernels (``kernels/fused_cuda.py``, sources in ``csrc/``)."""

from coherent_rtlsdr_tpu_torch.kernels.fft4step import FFT4Step, supported_fft_len
from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels, get_fused_kernels

__all__ = ["FFT4Step", "supported_fft_len", "FusedPipelineKernels", "get_fused_kernels"]
