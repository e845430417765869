"""Measurement/correction ops on the four-step FFT's permuted (k2, k1)
frequency layout (port of ``coherent_rtlsdr_tpu/kernels/permuted.py``):
the natural-order ops of ``ops/xcorr.py`` / ``ops/delay.py`` re-indexed, so
no reordering pass is ever materialized.

For W = m*m, natural bin k = k2 + m*k1:
  * contiguous 2m-bin bands (the phase-slope band sums) are fixed pairs of
    k1 columns over all k2 rows;
  * delay ramps need ``(k*d) mod W``, computed exactly on the index grid;
  * energies and Parseval sums are permutation-invariant.

``fft`` is any transform pair with ``fft_len``, ``m``, ``ifft`` and the two
grids: ``FFT4Step`` or ``FFT4StepKernel``.
"""

import torch

from coherent_rtlsdr_tpu_torch.ops.delay import expj, iramp_fraction
from coherent_rtlsdr_tpu_torch.ops.spectral import magsquared
from coherent_rtlsdr_tpu_torch.ops.xcorr import (
    LagEstimate,
    peak_estimate,
    signed_peak,
    slope_of_bands,
)


def _integer_ramp_phase_grid(fft, d_int: torch.Tensor) -> torch.Tensor:
    """:func:`ops.delay.iramp_fraction` on the (k2, k1) grid: ``d_int
    [...]`` -> ``[..., m, m]``."""
    return iramp_fraction(fft.freq_index_grid().to(torch.int64), d_int, fft.fft_len)


def delay_ramp_permuted(fft, delay: torch.Tensor) -> torch.Tensor:
    """``exp(-2 pi i f_k delay)`` on the permuted grid (x[n] -> x[n - delay])."""
    d = torch.as_tensor(delay, dtype=torch.float32, device=fft.device)
    d_int = torch.floor(d)
    d_frac = (d - d_int)[..., None, None]
    phase = _integer_ramp_phase_grid(fft, d_int) + fft.signed_freq_grid() * d_frac
    return expj(-2.0 * torch.pi * phase)


def apply_delay_phase_permuted(fft, Fp: torch.Tensor, advance: torch.Tensor,
                               phase: torch.Tensor) -> torch.Tensor:
    """Fractional *advance* and a complex phase on permuted spectra
    (``ops.delay.apply_delay_phase_freq`` analog); ``advance [...]`` applies
    to spectra ``[..., m, m]``."""
    adv = torch.as_tensor(advance, dtype=torch.float32, device=Fp.device)
    ramp = delay_ramp_permuted(fft, -adv)
    return Fp * ramp * torch.as_tensor(phase, device=Fp.device)[..., None, None]


def lag_estimate_permuted(fft, Fp_sig: torch.Tensor, Fp_ref: torch.Tensor,
                          method: str = "phase_slope") -> LagEstimate:
    """``ops.xcorr.lag_estimate_from_spectra`` on permuted spectra
    ``Fp_sig [..., N, m, m]`` against ``Fp_ref [..., m, m]``; methods
    ``phase_slope`` and ``integer``."""
    W, m = fft.fft_len, fft.m
    if method not in ("phase_slope", "integer"):
        raise ValueError(f"unsupported method for permuted layout: {method}")
    G = Fp_sig * torch.conj(Fp_ref)[..., None, :, :]
    m2 = magsquared(fft.ifft(G))                          # [..., N, W] natural order
    peak_idx, int_lag = signed_peak(m2)

    if method == "phase_slope":
        Gc = G * expj(-2.0 * torch.pi * _integer_ramp_phase_grid(fft, -int_lag))
        # 2m-bin bands (pairs of k1 columns), matching the natural-order estimator.
        frac = torch.clamp(slope_of_bands(Gc.reshape(*Gc.shape[:-2], m, m // 2, 2)
                                          .sum(dim=(-3, -1))), -0.5, 0.5)
        del Gc
    else:
        frac = torch.zeros_like(int_lag)
    del G

    e_sig = torch.sum(torch.abs(Fp_sig) ** 2, dim=(-2, -1)) / W
    e_ref = (torch.sum(torch.abs(Fp_ref) ** 2, dim=(-2, -1)) / W)[..., None]
    return peak_estimate(m2, peak_idx, int_lag, frac, e_sig, e_ref)
