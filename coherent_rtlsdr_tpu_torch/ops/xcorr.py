"""Batched FFT cross-correlation and sample-lag estimation (port of
``coherent_rtlsdr_tpu/ops/xcorr.py``).

Spectra in, ``LagEstimate`` out: cross-spectrum -> inverse FFT -> |c|^2 ->
argmax -> fractional refinement (``phase_slope``, ``parabolic`` or
``integer``), or the IFFT-free two-stage banded ``phase_zoom``. Every
function takes any number of leading batch dimensions where the JAX
package vmaps.

Sign convention: ``lag > 0`` means the signal channel is *delayed* by
``lag`` samples relative to the reference (sig[n] = ref[n - lag]).
"""

import math
from typing import NamedTuple, Optional

import torch

from coherent_rtlsdr_tpu_torch.ops.delay import _integer_delay_ramp_phase, expj
from coherent_rtlsdr_tpu_torch.ops.spectral import magsquared

_TWO_PI = 2.0 * math.pi


class LagEstimate(NamedTuple):
    """Per-channel lag measurement; leading dimensions are batch."""

    lag: torch.Tensor    # signed fractional lag in samples
    mag: torch.Tensor    # normalized correlation coefficient in [0, 1]
    papr: torch.Tensor   # peak-to-average power ratio of |xcorr|^2 (linear)


def cross_spectrum(sig: torch.Tensor, ref: torch.Tensor,
                   fft_len: Optional[int] = None) -> torch.Tensor:
    """Zero-padded cross-spectra ``FFT(sig) * conj(FFT(ref))``: sig ``[...,
    L]``, ref ``[L]``, padded to ``fft_len`` (default 2L)."""
    W = fft_len or 2 * sig.shape[-1]
    return torch.fft.fft(sig, n=W, dim=-1) * torch.conj(torch.fft.fft(ref, n=W, dim=-1))


def xcorr_circular(sig: torch.Tensor, ref: torch.Tensor,
                   fft_len: Optional[int] = None) -> torch.Tensor:
    """Cross-correlation ``c[m]`` in FFT ordering: bins above W/2 hold the
    negative lags ``m - W``."""
    return torch.fft.ifft(cross_spectrum(sig, ref, fft_len), dim=-1)


def parabolic_peak_offset(ym: torch.Tensor, y0: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    """3-point parabolic peak offset in [-0.5, 0.5]:
    0.5 (y- - y+) / (y- - 2 y0 + y+)."""
    denom = ym - 2.0 * y0 + yp
    ok = torch.abs(denom) > 1e-20
    offset = 0.5 * (ym - yp) / torch.where(ok, denom, 1.0)
    return torch.clamp(torch.where(ok, offset, 0.0), -0.5, 0.5)


def slope_of_bands(Gb: torch.Tensor) -> torch.Tensor:
    """Band-to-band phase slope of ``M`` coherent band sums ``Gb [..., M]``,
    in samples of lag; the one product straddling Nyquist is masked out."""
    M = Gb.shape[-1]
    prod = Gb[..., 1:] * torch.conj(Gb[..., :-1])
    mask = torch.arange(M - 1, device=Gb.device) != (M // 2 - 1)
    s = torch.sum(prod * mask, dim=-1)
    return -torch.angle(s) * M / _TWO_PI


def _band_slope(Gc: torch.Tensor, M: int) -> torch.Tensor:
    """:func:`slope_of_bands` of a spectrum summed into ``M`` bands."""
    W = Gc.shape[-1]
    return slope_of_bands(Gc.reshape(*Gc.shape[:-1], M, W // M).sum(-1))


def _deramp(G: torch.Tensor, int_lag: torch.Tensor) -> torch.Tensor:
    """``G * exp(+2 pi i k int_lag / W)`` with ``k * lag`` reduced mod W
    exactly."""
    phase = _integer_delay_ramp_phase(G.shape[-1], -int_lag)
    return G * expj(-2.0 * torch.pi * phase).to(G.dtype)


def _phase_slope_offset(G: torch.Tensor, int_lag: torch.Tensor, n_bands: int = 64) -> torch.Tensor:
    """Fractional lag from the integer-compensated cross-spectrum, summed
    into ``n_bands`` coherent bands; unambiguous for |frac| < 0.5."""
    W = G.shape[-1]
    M = min(n_bands, max(4, W // 4))
    return torch.clamp(_band_slope(_deramp(G, int_lag), M), -0.5, 0.5)


def _phase_zoom_estimate(G: torch.Tensor) -> LagEstimate:
    """IFFT-free lag estimation: two banded phase-slope stages (W/8 bands,
    then 64 after removing the rounded coarse lag). ``mag`` is |z|, the
    unnormalized correlation value at the fractional lag (the caller
    normalizes); PAPR is Parseval's |z|^2 / sum|G|^2."""
    W = G.shape[-1]
    int_lag = torch.round(_band_slope(G, max(64, W // 8)))
    Gc = _deramp(G, int_lag)
    frac = torch.clamp(_band_slope(Gc, 64), -4.0, 4.0)
    f = torch.fft.fftfreq(W, dtype=torch.float64, device=G.device).float()
    z = torch.sum(Gc * expj((_TWO_PI * f) * frac[..., None]).to(G.dtype), dim=-1)
    e2 = torch.sum(torch.abs(G) ** 2, dim=-1)
    mag = torch.abs(z)
    return LagEstimate(lag=int_lag + frac, mag=mag,
                       papr=mag * mag / torch.where(e2 > 0, e2, 1.0))


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx[..., None])[..., 0]


def signed_peak(m2: torch.Tensor):
    """argmax of ``|c|^2 [..., W]`` in FFT ordering -> (peak index, signed
    integer lag as float32)."""
    W = m2.shape[-1]
    peak_idx = torch.argmax(m2, dim=-1)
    return peak_idx, torch.where(peak_idx > W // 2, peak_idx - W, peak_idx).to(torch.float32)


def peak_estimate(m2: torch.Tensor, peak_idx: torch.Tensor, int_lag: torch.Tensor,
                  frac: torch.Tensor, e_sig: torch.Tensor, e_ref: torch.Tensor) -> LagEstimate:
    """The estimate at the ``|c|^2`` peak: mag = |c_peak| / sqrt(E_sig
    E_ref) with Parseval energies, the integer-bin scalloping sinc(frac)
    undone; PAPR of ``|c|^2``."""
    peak_pow = _gather(m2, peak_idx)
    denom = torch.sqrt(e_sig * e_ref)
    mag = torch.sqrt(peak_pow) / torch.where(denom > 0, denom, 1.0)
    mag = mag / torch.clamp(torch.abs(torch.sinc(frac)), min=0.5)
    mean_pow = torch.mean(m2, dim=-1)
    papr = peak_pow / torch.where(mean_pow > 0, mean_pow, 1.0)
    return LagEstimate(lag=int_lag + frac, mag=mag, papr=papr)


def lag_estimate_from_spectra(
    F_sig: torch.Tensor,
    F_ref: torch.Tensor,
    valid_corr_len: Optional[int] = None,
    method: str = "phase_slope",
) -> LagEstimate:
    """Lag estimation from precomputed spectra ``F_sig [..., N, W]``
    against ``F_ref [..., W]``. ``valid_corr_len`` limits the argmax search
    to lags in ``(-V/2, V/2]``. Methods: ``phase_slope``, ``parabolic``,
    ``integer``, ``phase_zoom``."""
    W = F_sig.shape[-1]
    G = F_sig * torch.conj(F_ref)[..., None, :]
    e_sig = torch.sum(torch.abs(F_sig) ** 2, dim=-1) / W
    e_ref = (torch.sum(torch.abs(F_ref) ** 2, dim=-1) / W)[..., None]

    if method == "phase_zoom":
        est = _phase_zoom_estimate(G)
        denom = W * torch.sqrt(e_sig * e_ref)
        return LagEstimate(lag=est.lag, mag=est.mag / torch.where(denom > 0, denom, 1.0),
                           papr=est.papr)

    m2 = magsquared(torch.fft.ifft(G, dim=-1))
    m2_search = m2
    if valid_corr_len is not None and valid_corr_len < W:
        V = valid_corr_len
        idx = torch.arange(W, device=G.device)
        signed = torch.where(idx > W // 2, idx - W, idx)
        m2_search = torch.where((signed > -V // 2) & (signed <= V // 2), m2, 0.0)
    peak_idx, int_lag = signed_peak(m2_search)

    if method == "phase_slope":
        frac = _phase_slope_offset(G, int_lag)
    elif method == "parabolic":
        y0 = torch.sqrt(_gather(m2, peak_idx))
        ym = torch.sqrt(_gather(m2, (peak_idx - 1) % W))
        yp = torch.sqrt(_gather(m2, (peak_idx + 1) % W))
        frac = parabolic_peak_offset(ym, y0, yp)
    elif method == "integer":
        frac = torch.zeros_like(int_lag)
    else:
        raise ValueError(f"unknown fractional-lag method: {method}")
    return peak_estimate(m2, peak_idx, int_lag, frac, e_sig, e_ref)


def lag_estimate_batched(sig: torch.Tensor, ref: torch.Tensor, fft_len: Optional[int] = None,
                         method: str = "phase_slope") -> LagEstimate:
    """Batched lag estimation ``sig [N, L]`` against ``ref [L]``, circular
    (no zero-padding unless ``fft_len`` asks for it)."""
    W = fft_len or sig.shape[-1]
    return lag_estimate_from_spectra(torch.fft.fft(sig, n=W, dim=-1),
                                     torch.fft.fft(ref, n=W, dim=-1), method=method)


def lag_estimate(sig: torch.Tensor, ref: torch.Tensor, fft_len: Optional[int] = None,
                 method: str = "phase_slope") -> LagEstimate:
    """Single-channel wrapper: ``sig [L]`` against ``ref [L]``."""
    est = lag_estimate_batched(sig[None, :], ref, fft_len, method)
    return LagEstimate(lag=est.lag[0], mag=est.mag[0], papr=est.papr[0])
