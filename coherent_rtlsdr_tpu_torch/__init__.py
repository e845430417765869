"""coherent_rtlsdr_tpu_torch - the PyTorch/CUDA port of coherent_rtlsdr_tpu.

Two paths on one NVIDIA H100, each through hand-written CUDA C++ kernels for
sm_90a (``csrc/``) with a plain PyTorch version beside each kernel that
runs on CPU tensors:

* the fused i8 chain (``fft_impl="fused"``): raw u8 IQ bytes -> XOR 0x80 ->
  measure kernel -> control law (streaming) or smoother (offline) -> phase
  EMA -> apply kernel -> int8 wire bytes;
* the generic spectral-backend pipeline (``fft_impl`` "xla", "mxu",
  "pallas"): window spectra -> lag estimate -> control law or smoother ->
  fractional advance -> phase EMA -> aligned complex blocks, with the
  four-step FFT kernel behind "pallas", and ``FusedSpectral`` over the float
  measure/apply kernels.

Downstream of the aligned frames, the array models (MUSIC, Bartlett,
MVDR, ESPRIT, root-MUSIC, co-array and near-field localization) run on
``torch.linalg`` and batched products.

Every entry point runs on the card unless the caller passes CPU tensors or
``device="cpu"``.

Subpackages mirror the JAX package, which stays the reference:

ops        conversion, phase EMA, delay ramps, spectral stats, lag estimation
kernels    four-step FFT, fused measure/apply, permuted ops, backends
pipeline   state, control law, streaming step and drivers, offline engine
signal     synthetic capture with ground truth, the server's block sources
io         the streaming server and its host edge (wire, console, ZMQ,
           client, drift relief)
native     the C++ host runtime (block ring, file / ZMQ / librtlsdr capture
           threads, packetizer and publisher), built with g++ at first use
models     array geometries, steering, covariance, DOA spectra, co-array
           and near-field localization
parallel   the (time, channel) mesh of torch.distributed ranks and the
           sharded offline runners and step
apps       the server, the offline aligner, the capture daemon and the
           MUSIC heatmap client

The package imports torch and numpy, and nothing of JAX or of the JAX
package.
"""

__version__ = "0.1.0"
