"""int8/uint8 IQ <-> complex-float conversion (port of
``coherent_rtlsdr_tpu/ops/convert.py``).

Wire layout: interleaved IQ bytes ``[..., L, 2]`` (I then Q); the capture is
unsigned offset-binary, the wire is signed int8.
"""

import torch

from coherent_rtlsdr_tpu_torch.constants import IQ_SCALE


def c2f(x: torch.Tensor) -> torch.Tensor:
    """complex ``[...]`` -> float32 ``[..., 2]`` (re, im)."""
    return torch.stack([x.real, x.imag], dim=-1).to(torch.float32)


def f2c(x: torch.Tensor) -> torch.Tensor:
    """float32 ``[..., 2]`` -> complex64 ``[...]``."""
    return torch.complex(x[..., 0].float(), x[..., 1].float())


def u8_to_i8(raw_u8: torch.Tensor) -> torch.Tensor:
    """Offset-binary uint8 -> signed int8 (value - 128), the XOR 0x80 of the
    capture bytes."""
    return (raw_u8 ^ 0x80).view(torch.int8)


def u8_to_c64(raw_u8: torch.Tensor, scale: float = IQ_SCALE) -> torch.Tensor:
    """``[..., L, 2]`` uint8 interleaved IQ -> ``[..., L]`` complex64,
    value = (u8 - 128) * scale (the generic path's input)."""
    f = raw_u8.to(torch.float32) - 128.0
    return torch.complex(f[..., 0] * scale, f[..., 1] * scale)


def i8_iq_to_c64(raw_i8: torch.Tensor, scale: float = IQ_SCALE) -> torch.Tensor:
    """``[..., L, 2]`` int8 interleaved IQ -> ``[..., L]`` complex64."""
    f = raw_i8.to(torch.float32)
    return torch.complex(f[..., 0] * scale, f[..., 1] * scale)


def c64_to_i8_iq(x: torch.Tensor, scale: float = 1.0 / IQ_SCALE) -> torch.Tensor:
    """``[..., L]`` complex64 -> ``[..., L, 2]`` int8 interleaved IQ, rounded
    half to even and saturated."""
    iq = torch.stack([x.real, x.imag], dim=-1) * scale
    return torch.clamp(torch.round(iq), -128.0, 127.0).to(torch.int8)
