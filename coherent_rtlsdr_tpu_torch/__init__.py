"""coherent_rtlsdr_tpu_torch - the PyTorch/CUDA port of coherent_rtlsdr_tpu.

The fused i8 alignment chain on one NVIDIA H100: raw u8 IQ bytes -> XOR 0x80
-> measure kernel -> control law (streaming) or smoother (offline) -> phase
EMA -> apply kernel -> int8 wire bytes. The two kernels are CUDA C++ written
by hand for sm_90a (``csrc/``); each has a plain PyTorch version beside it
(``kernels/fused.py``) that runs on CPU tensors.

Subpackages mirror the JAX package, which stays the reference:

ops        conversion, phase EMA, delay ramp
kernels    four-step FFT tables and the fused measure/apply pair
pipeline   state, control law, streaming step and drivers, offline engine
signal     synthetic capture with ground truth

The package imports torch and numpy, and nothing of JAX or of the JAX
package.
"""

__version__ = "0.1.0"
