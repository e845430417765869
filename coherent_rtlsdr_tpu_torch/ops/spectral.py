"""Small spectral/statistics ops (port of
``coherent_rtlsdr_tpu/ops/spectral.py``): ``magsquared``, ``rms``,
``crest_factor``, ``papr`` and ``conj_dot``."""

import torch


def magsquared(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 elementwise, without the sqrt of ``abs``."""
    return x.real ** 2 + x.imag ** 2


def rms(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """Root-mean-square; complex inputs use |x|^2."""
    if x.is_complex():
        return torch.sqrt(torch.mean(magsquared(x), dim=dim))
    return torch.sqrt(torch.mean(x * x, dim=dim))


def crest_factor(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """Peak amplitude / RMS."""
    peak = torch.amax(torch.abs(x), dim=dim)
    r = rms(x, dim=dim)
    return peak / torch.where(r > 0, r, 1.0)


def papr(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """Peak-to-average power ratio (linear)."""
    p = magsquared(x) if x.is_complex() else x * x
    mean = torch.mean(p, dim=dim)
    return torch.amax(p, dim=dim) / torch.where(mean > 0, mean, 1.0)


def conj_dot(a: torch.Tensor, b: torch.Tensor, dim=-1) -> torch.Tensor:
    """``sum(a * conj(b))``."""
    return torch.sum(a * torch.conj(b), dim=dim)
