"""Fractional-delay correction (port of ``coherent_rtlsdr_tpu/ops/delay.py``):
the delay ramp, its application with a phase factor and the overlap-save
streaming advance in the frequency domain, and the 4-tap cubic-Lagrange
Farrow interpolator in the time domain (per-sample advances, e.g. the
synthesizer's residual clock skew).

Sign convention: a channel measured at lag d (delayed by d) is corrected by
advancing it d samples.
"""

from typing import Tuple

import torch


def iramp_fraction(k: torch.Tensor, d_int: torch.Tensor, W: int) -> torch.Tensor:
    """Exact phase fraction ``(k * d) mod W / W`` of integer delays ``d_int
    [...]`` (any dtype holding integers) over the bin indices ``k`` (int64,
    any shape) -> ``[..., *k.shape]``.

    ``f32(k/W) * d`` would lose ~eps*|d| cycles of phase, so the modular
    reduction is done in int64, where ``k * (d mod W)`` is exact for every
    W this package uses.
    """
    dm = torch.remainder(d_int.to(torch.int64), W)
    dm = dm.reshape(*dm.shape, *([1] * k.dim()))
    return torch.remainder(k * dm, W).to(torch.float32) / W


def _integer_delay_ramp_phase(fft_len: int, d_int: torch.Tensor) -> torch.Tensor:
    """:func:`iramp_fraction` over the natural-order bins ``[W]``."""
    k = torch.arange(fft_len, dtype=torch.int64, device=d_int.device)
    return iramp_fraction(k, d_int, fft_len)


def expj(theta: torch.Tensor) -> torch.Tensor:
    """``exp(i * theta)`` as complex64 for float32 ``theta``."""
    return torch.polar(torch.ones_like(theta), theta)


def delay_ramp(fft_len: int, delay: torch.Tensor, dtype=torch.complex64) -> torch.Tensor:
    """Spectrum multiplier implementing ``x[n] -> x[n - delay]``.

    ``delay`` may be batched ``[...]``; returns ``[..., fft_len]``. Signed
    FFT frequencies make fractional delays interpolate symmetrically; the
    integer part is reduced with exact modular arithmetic, so the phase error
    stays ~1e-7 cycles whatever the delay.
    """
    if fft_len & (fft_len - 1):
        raise ValueError("delay_ramp requires a power-of-two fft_len")
    d = torch.as_tensor(delay, dtype=torch.float32)
    d_int = torch.floor(d)
    d_frac = (d - d_int)[..., None]
    f = torch.fft.fftfreq(fft_len, dtype=torch.float32, device=d.device)
    phase = _integer_delay_ramp_phase(fft_len, d_int) + f * d_frac
    return expj(-2.0 * torch.pi * phase).to(dtype)


def apply_delay_phase_freq(F: torch.Tensor, advance: torch.Tensor,
                           phase: torch.Tensor) -> torch.Tensor:
    """Fractional *advance* and a complex phase factor in the frequency
    domain. F: ``[..., W]`` spectra; advance: ``[...]`` samples; phase:
    ``[...]`` unit-modulus complex."""
    W = F.shape[-1]
    adv = torch.as_tensor(advance, dtype=torch.float32, device=F.device)
    ramp = delay_ramp(W, -adv, dtype=F.dtype)
    return F * ramp * torch.as_tensor(phase, device=F.device)[..., None]


def overlap_save_advance(hist: torch.Tensor, cur: torch.Tensor, advance: torch.Tensor,
                         phase: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming fractional advance with overlap-save.

    hist, cur: ``[..., L]`` (previous and current block); advance ``[...]``
    samples, valid for ``|advance| <= L/2``; phase ``[...]`` complex.
    Returns ``(new_hist, out)``, where ``out[n]`` is the corrected sample
    at stream time ``t0 - L/2 + n`` (t0 = first sample of ``cur``): a fixed
    latency of L/2 samples buys a +/- L/2 correction range.
    """
    L = cur.shape[-1]
    w = torch.cat([hist, cur], dim=-1)
    y = torch.fft.ifft(apply_delay_phase_freq(torch.fft.fft(w, dim=-1), advance, phase), dim=-1)
    return cur, y[..., L // 2: L // 2 + L].to(w.dtype)


# --- Farrow cubic-Lagrange interpolator -----------------------------------

def _farrow_coeffs(mu: torch.Tensor):
    """Cubic Lagrange basis at ``mu`` in [0, 1) between taps x[n] and
    x[n+1], over the taps x[n-1], x[n], x[n+1], x[n+2]."""
    m = torch.as_tensor(mu, dtype=torch.float32)
    c_m1 = -m * (m - 1.0) * (m - 2.0) / 6.0
    c_0 = (m + 1.0) * (m - 1.0) * (m - 2.0) / 2.0
    c_p1 = -(m + 1.0) * m * (m - 2.0) / 2.0
    c_p2 = (m + 1.0) * m * (m - 1.0) / 6.0
    return c_m1, c_0, c_p1, c_p2


def farrow_fractional_delay(x: torch.Tensor, advance) -> torch.Tensor:
    """``x(n + advance)`` by a 4-tap cubic-Lagrange Farrow FIR.

    x: ``[..., T]``; advance: a scalar, ``[...]`` (one per batch row) or
    ``[..., T]`` / ``[T]`` (one per sample). Indices wrap circularly, so
    callers keep ``ceil(|advance|) + 2`` samples of margin.
    """
    T = x.shape[-1]
    a = torch.as_tensor(advance, dtype=torch.float32, device=x.device)
    if a.dim() == x.dim() - 1 and a.dim() > 0:
        a = a[..., None]   # one advance per batch row, broadcast over time
    pos = torch.arange(T, dtype=torch.float32, device=x.device) + a
    n0 = torch.floor(pos)
    mu = (pos - n0).expand(x.shape)
    n0 = n0.to(torch.int64).expand(x.shape)
    taps = [torch.gather(x, -1, torch.remainder(n0 + k, T)) for k in (-1, 0, 1, 2)]
    return sum(t * c.to(x.dtype) for t, c in zip(taps, _farrow_coeffs(mu)))
