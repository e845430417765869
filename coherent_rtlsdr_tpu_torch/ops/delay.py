"""Fractional-delay spectrum ramp (port of the ramp half of
``coherent_rtlsdr_tpu/ops/delay.py``), used by the synthesizer.

Sign convention: a channel measured at lag d (delayed by d) is corrected by
advancing it d samples. The time-domain Farrow interpolator is not ported
yet (ROADMAP.md, Queue 1).
"""

import torch


def _integer_delay_ramp_phase(fft_len: int, d_int: torch.Tensor) -> torch.Tensor:
    """Exact phase fraction ``(k * d) mod W / W`` for integer delays.

    ``f32(k/W) * d`` would lose ~eps*|d| cycles of phase, so the modular
    reduction is done in int64, where ``k * (d mod W)`` is exact for every
    W this package uses.
    """
    W = fft_len
    k = torch.arange(W, dtype=torch.int64, device=d_int.device)
    dm = torch.remainder(d_int.to(torch.int64), W)[..., None]
    return torch.remainder(k * dm, W).to(torch.float32) / W


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
    return torch.exp(torch.complex(torch.zeros_like(phase), -2.0 * torch.pi * phase)).to(dtype)
