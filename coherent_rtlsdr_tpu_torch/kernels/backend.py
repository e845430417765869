"""Spectral backend selection (port of
``coherent_rtlsdr_tpu/kernels/backend.py``): one interface over the
natural-order ``torch.fft`` path, the four-step permuted path (plain
products or the CUDA four-step kernel), and the fused measure/apply kernels,
so that the pipeline code is written once (``pipeline/step.py``,
``pipeline/offline.py``).

Every backend implements the pipeline interface over STREAM BLOCKS (the
overlap-save window of output slot t is blocks (t, t+1)):

    ctx = sp.prepare(sig_blocks, ref_blocks)  # [T, N, L] / [T, L] complex
    est = sp.measure(ctx, method)             # LagEstimate over [T-1, N]
    y   = sp.correct(ctx, advance)            # aligned centre half [T-1, N, L]

plus the lower-level ``fft`` / ``ifft`` (and, for xla/mxu, ``lag_estimate``
/ ``apply_advance``). ``correct`` returns ``y[..., W/4:3W/4]`` per window.
"""

import functools
from typing import NamedTuple

import torch

from coherent_rtlsdr_tpu_torch.kernels import permuted as perm
from coherent_rtlsdr_tpu_torch.kernels.fft4step import FFT4Step, supported_fft_len
from coherent_rtlsdr_tpu_torch.kernels.fourstep import get_fourstep_kernel
from coherent_rtlsdr_tpu_torch.kernels.fused import get_fused_kernels, resolve_device
from coherent_rtlsdr_tpu_torch.ops.delay import apply_delay_phase_freq
from coherent_rtlsdr_tpu_torch.ops.xcorr import LagEstimate, lag_estimate_from_spectra


class _Ctx(NamedTuple):
    F_sig: torch.Tensor   # [..., N, spectrum]
    F_ref: torch.Tensor   # [..., spectrum]


def _windows(blocks: torch.Tensor) -> torch.Tensor:
    """Blocks ``[T, ..., L]`` -> overlap-save windows ``[T-1, ..., 2L]``."""
    return torch.cat([blocks[:-1], blocks[1:]], dim=-1)


class _SpectraBackend:
    """The pipeline interface over a subclass's ``fft``, ``ifft``,
    ``lag_estimate`` and ``apply_advance``: window spectra are taken once
    and feed both measurement and correction."""

    fft_len: int

    def prepare(self, sig_blocks, ref_blocks):
        return _Ctx(self.fft(_windows(sig_blocks)), self.fft(_windows(ref_blocks)))

    def measure(self, ctx, method):
        return self.lag_estimate(ctx.F_sig, ctx.F_ref, method)

    def correct(self, ctx, advance):
        W = self.fft_len
        one = torch.ones((), dtype=torch.complex64, device=ctx.F_sig.device)
        y = self.ifft(self.apply_advance(ctx.F_sig, advance, one))
        return y[..., W // 4: W // 4 + W // 2]


class XlaSpectral(_SpectraBackend):
    """Natural-order spectra via ``torch.fft`` (cuFFT on the card)."""

    def __init__(self, fft_len: int):
        self.fft_len = fft_len

    def fft(self, x):
        return torch.fft.fft(x, dim=-1)

    def ifft(self, S):
        return torch.fft.ifft(S, dim=-1)

    def lag_estimate(self, S_sig, S_ref, method):
        return lag_estimate_from_spectra(S_sig, S_ref, method=method)

    def apply_advance(self, S, advance, phase):
        return apply_delay_phase_freq(S, advance, phase)


class MxuSpectral(_SpectraBackend):
    """Permuted-layout spectra via the four-step FFT: plain products at
    ``precision`` ("bf16" or "f32"), or with ``pallas=True`` the CUDA
    four-step kernel (bf16 operands, as the JAX package's Pallas kernel)."""

    def __init__(self, fft_len: int, precision: str = "bf16", pallas: bool = False,
                 device="cuda"):
        if pallas:
            self._fft = get_fourstep_kernel(fft_len, device)
        else:
            self._fft = FFT4Step(fft_len, device, precision=precision)
        self.fft_len = fft_len

    def fft(self, x):
        return self._fft.fft(x)

    def ifft(self, S):
        return self._fft.ifft(S)

    def lag_estimate(self, S_sig, S_ref, method):
        return perm.lag_estimate_permuted(self._fft, S_sig, S_ref, method=method)

    def apply_advance(self, S, advance, phase):
        return perm.apply_delay_phase_permuted(self._fft, S, advance, phase)


class _FusedCtx(NamedTuple):
    pre: torch.Tensor   # [T, N, m/2, m] bf16 block planes
    pim: torch.Tensor
    rre: torch.Tensor   # [T-1, m, m] bf16 permuted reference window spectra
    rim: torch.Tensor


class FusedSpectral:
    """The float fused measure/apply kernels (``FusedPipelineKernels.measure``
    / ``.apply``): spectra never leave the kernel. Lag estimation is the
    phase-zoom algorithm, computed inside the measure kernel."""

    def __init__(self, fft_len: int, device="cuda"):
        self._k = get_fused_kernels(fft_len, device)
        self._reffft = get_fourstep_kernel(fft_len, device)
        self.fft_len = fft_len

    def fft(self, x):
        return self._reffft.fft(x)

    def ifft(self, S):
        return self._reffft.ifft(S)

    def prepare(self, sig_blocks, ref_blocks):
        """Blocks stored once as bf16 planes (the kernels round to bf16
        anyway); only the reference windows are transformed here."""
        m = self._k.m
        T, N, L = sig_blocks.shape
        ps = sig_blocks.reshape(T, N, m // 2, m)
        R = self._reffft.fft(_windows(ref_blocks))
        bf = lambda x: x.to(torch.bfloat16)
        return _FusedCtx(pre=bf(ps.real), pim=bf(ps.imag), rre=bf(R.real), rim=bf(R.imag))

    def measure(self, ctx, method):
        if method not in ("phase_zoom", "auto"):
            raise ValueError(
                "fft_impl='fused' computes lag in-kernel with the phase_zoom "
                f"estimator; set lag_method='phase_zoom' (got '{method}')")
        lag, zabs, esig, eg = self._k.measure(ctx.pre, ctx.pim, ctx.rre, ctx.rim)
        rre = ctx.rre.to(torch.float32)
        rim = ctx.rim.to(torch.float32)
        e_ref = torch.sum(rre * rre + rim * rim, dim=(-2, -1))   # [T-1]
        denom = torch.sqrt(esig * e_ref[:, None])
        mag = zabs / torch.where(denom > 0, denom, 1.0)
        # Parseval PAPR: peak |c| ~ |z|/W, mean |c|^2 = sum |G|^2 / W^2.
        papr = zabs * zabs / torch.where(eg > 0, eg, 1.0)
        return LagEstimate(lag=lag, mag=mag, papr=papr)

    def correct(self, ctx, advance):
        T1, N = ctx.pre.shape[0] - 1, ctx.pre.shape[1]
        adv = torch.as_tensor(advance, dtype=torch.float32, device=ctx.pre.device)
        yre, yim = self._k.apply(ctx.pre, ctx.pim, adv.reshape(T1, N))
        return torch.complex(yre, yim)


@functools.lru_cache(maxsize=None)
def _backend(kind: str, fft_len: int, precision: str, device: torch.device):
    if kind == "fused":
        return FusedSpectral(fft_len, device)
    if kind == "xla":
        return XlaSpectral(fft_len)
    return MxuSpectral(fft_len, precision=precision, pallas=(kind == "pallas"), device=device)


def get_spectral(cfg, fft_len: int, device="cuda"):
    """The backend of ``cfg.fft_impl`` ("xla" | "mxu" | "pallas" | "fused"
    | "auto") for ``fft_len`` on ``device``; "auto" takes "mxu" when the
    length is a supported square. One instance per (backend, length,
    precision, device) in the process."""
    impl = getattr(cfg, "fft_impl", "xla")
    kind = "xla"
    if impl in ("mxu", "pallas", "fused") or (impl == "auto" and supported_fft_len(fft_len)):
        if not supported_fft_len(fft_len):
            raise ValueError(f"fft_impl='{impl}' needs a square fft_len in "
                             f"{{4096, 16384, 65536}}, got {fft_len}")
        kind = "mxu" if impl == "auto" else impl
    return _backend(kind, fft_len, getattr(cfg, "mxu_precision", "bf16"),
                    resolve_device(device))
