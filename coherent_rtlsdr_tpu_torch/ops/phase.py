"""Per-channel complex phase correction (port of
``coherent_rtlsdr_tpu/ops/phase.py``): the correction factor is the
normalized conjugate of the signal-vs-reference inner product, smoothed with
an EMA and applied as a complex scalar multiply."""

import torch

from coherent_rtlsdr_tpu_torch.constants import PHASE_EMA_ALPHA


def unit_phasor(z: torch.Tensor) -> torch.Tensor:
    """``z / |z|``, and 1 where ``z == 0``."""
    mag = torch.abs(z)
    one = torch.ones((), dtype=z.dtype, device=z.device)
    return torch.where(mag > 0, z / torch.where(mag > 0, mag, 1.0), one)


def phase_correction_estimate(sig: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Instantaneous unit-modulus correction factor per channel.

    sig: ``[..., L]``; ref: ``[L]``. Returns ``[...]`` complex64 such that
    ``sig * factor`` is phase-aligned with ``ref``:
    ``factor = conj(<sig, ref*>) / |<sig, ref*>|``.
    """
    z = torch.sum(sig * torch.conj(ref), dim=-1)
    return unit_phasor(torch.conj(z)).to(torch.complex64)


def ema_complex(
    prev: torch.Tensor,
    new: torch.Tensor,
    alpha: float = PHASE_EMA_ALPHA,
    renormalize: bool = True,
) -> torch.Tensor:
    """EMA of complex factors, ``alpha`` = weight of the new sample.
    ``renormalize`` keeps the result unit-modulus so the correction never
    scales amplitude."""
    out = (1.0 - alpha) * prev + alpha * new
    if renormalize:
        out = unit_phasor(out)
    return out.to(torch.complex64)
