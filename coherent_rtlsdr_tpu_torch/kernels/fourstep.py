"""The four-step FFT as one CUDA kernel per transform direction (port of
``coherent_rtlsdr_tpu/kernels/pallas_fft.py:FFT4StepPallas``).

``FFT4StepKernel`` is the transform pair of ``fft_impl="pallas"`` and of
``FusedSpectral``: the same permuted (k2, k1) layout and bf16-operand /
float32-accumulate products as ``FFT4Step(precision="bf16")``, which is its
plain version. A CPU tensor runs the plain version; a CUDA tensor launches
``csrc/fourstep.cu`` (bound in ``kernels/fused_cuda.py``) or raises. The
instance counts forward and inverse launches and plain runs apart.

The kernel runs both products on the tensor cores (``mma.sync`` bf16 ->
f32), each complex product as four real ones, from the packed bf16 tables
that ``packed_tables`` builds once an instance; the inverse runs transposed
(C^T = Fi G^T, x^T = B^T Fi), which F, Fi and the twiddle being symmetric
allows. A persistent grid of one CTA an SM walks the batch while producer
warps stream the next window in (see the note in ``csrc/fourstep.cu``). At
m = 256 (W = 65536) a transform runs on a cluster of four CTAs (the packed
planes, 256 kB, fit no CTA), which stream F or Fi through shared memory as
the bf16 k-slices of ``fused.cluster_slices``.
"""

import functools

import torch

from coherent_rtlsdr_tpu_torch.kernels.fft4step import FFT4Step
from coherent_rtlsdr_tpu_torch.kernels.fused import CLUSTER_M, cluster_slices, resolve_device

COUNTS = ("fft_launches", "ifft_launches", "fft_plain_runs", "ifft_plain_runs")


def packed_tables(fft: FFT4Step):
    """The kernel's tables from a bf16 ``FFT4Step``: F and Fi = conj(F)/m
    as bf16 ``[2, m, m]`` (re, im) planes, the same values as its
    bf16-rounded tables. (The float32 twiddle is the one the measure and
    apply kernels take, ``fused_cuda._tables``.)"""
    plane = lambda re, im: torch.stack([re, im]).to(torch.bfloat16).contiguous()
    return plane(fft.fre, fft.fim), plane(fft.fire, fft.fiim)


class FFT4StepKernel:
    """Transform pair for one ``fft_len = m*m`` on one device."""

    def __init__(self, fft_len: int, device="cuda"):
        self.plain = FFT4Step(fft_len, device)
        self.fft_len = fft_len
        self.m = self.plain.m
        self.device = self.plain.device
        self.f_packed, self.fi_packed = (cluster_slices(self.plain) if self.m == CLUSTER_M
                                         else packed_tables(self.plain))
        self.reset_counts()

    def reset_counts(self):
        """Zero the counts: launches of the kernel, counted by the wrapper
        in ``fused_cuda`` right after it launches, and plain runs."""
        for name in COUNTS:
            setattr(self, name, 0)

    def counts(self) -> dict:
        return {name: getattr(self, name) for name in COUNTS}

    def _batch(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., W]`` or ``[..., m, m]`` -> complex64 ``[B, m, m]``,
        contiguous and 16-byte aligned as the kernel takes it (a view that
        is not is copied)."""
        m = self.m
        if x.shape[-1] == self.fft_len:
            x = x.reshape(*x.shape[:-1], m, m)
        x = x.to(torch.complex64).reshape(-1, m, m).contiguous()
        return x.clone() if x.data_ptr() % 16 else x

    def _run(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        if x.is_cuda:
            from coherent_rtlsdr_tpu_torch.kernels import fused_cuda

            return fused_cuda.fourstep(self, self._batch(x), inverse)
        if x.device.type == "cpu":
            return self.ifft_plain(x) if inverse else self.fft_plain(x)
        raise ValueError(f"no four-step FFT for device {x.device}")

    def fft(self, x: torch.Tensor) -> torch.Tensor:
        """x ``[..., W]`` (or ``[..., m, m]``) -> permuted spectrum
        ``[..., m, m]``."""
        lead = x.shape[:-1] if x.shape[-1] == self.fft_len else x.shape[:-2]
        return self._run(x, inverse=False).reshape(*lead, self.m, self.m)

    def ifft(self, Xp: torch.Tensor) -> torch.Tensor:
        """Permuted spectrum ``[..., m, m]`` -> natural-order time ``[..., W]``."""
        return self._run(Xp, inverse=True).reshape(*Xp.shape[:-2], self.fft_len)

    def fft_plain(self, x: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch version of :meth:`fft` (``FFT4Step`` at bf16)."""
        self.fft_plain_runs += 1
        return self.plain.fft(x.reshape(*x.shape[:-2], self.fft_len)
                              if x.shape[-1] != self.fft_len else x)

    def ifft_plain(self, Xp: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch version of :meth:`ifft`."""
        self.ifft_plain_runs += 1
        return self.plain.ifft(Xp)

    def freq_index_grid(self) -> torch.Tensor:
        return self.plain.freq_index_grid()

    def signed_freq_grid(self) -> torch.Tensor:
        return self.plain.signed_freq_grid()


@functools.lru_cache(maxsize=None)
def _cached(fft_len: int, device: torch.device) -> FFT4StepKernel:
    return FFT4StepKernel(fft_len, device)


def get_fourstep_kernel(fft_len: int, device="cuda") -> FFT4StepKernel:
    """The one :class:`FFT4StepKernel` per (fft_len, device) of the
    process, so its launch counts cover every caller."""
    return _cached(fft_len, resolve_device(device))
