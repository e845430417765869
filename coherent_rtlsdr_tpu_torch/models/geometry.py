"""Array geometries and steering vectors (port of
``coherent_rtlsdr_tpu/models/geometry.py``).

Conventions follow the reference's MATLAB analysis stack
(matlabclient/functions/pmusic.m, measurement_script.m): planar arrays in
units of wavelengths, direction cosines (u, v) scanned over [-1, 1]^2 — the
+-90 x +-90 degree grid of pmusic.m:19-25 and heatmap2d.cpp:106-147.

Element positions stay numpy arrays, the same arrays the JAX package
returns. Tensors follow the device of their tensor inputs; a function with
none takes ``device``, by default the card, and raises when there is none.
Phases are float32 and steering matrices complex64, as in the JAX package
(64-bit off).
"""

import math
from typing import Tuple

import numpy as np
import torch


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for the card when there is
    none (the models never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("coherent_rtlsdr_tpu_torch.models runs on the card by default and "
                           "found none; pass device='cpu' or CPU tensors")
    return dev


def as_tensor(x, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``x`` (a tensor or an array) as a tensor of ``dtype`` on ``device``.
    With ``device=None`` a tensor stays where it lies and an array goes to
    the card."""
    if torch.is_tensor(x):
        return x.to(device=x.device if device is None else check_device(device), dtype=dtype)
    dev = check_device("cuda" if device is None else device)
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


def _device_of(*xs, device=None):
    """``device`` if given, else the device of the first tensor among
    ``xs``, else the card."""
    if device is not None:
        return check_device(device)
    for x in xs:
        if torch.is_tensor(x):
            return x.device
    return check_device("cuda")


def _phasor(phase: torch.Tensor) -> torch.Tensor:
    """exp(i * phase) as complex64."""
    return torch.complex(torch.cos(phase), torch.sin(phase))


def ula_positions(n: int, spacing: float = 0.5) -> np.ndarray:
    """Uniform linear array on the x axis; spacing in wavelengths."""
    pos = np.zeros((n, 2), np.float32)
    pos[:, 0] = np.arange(n) * spacing
    return pos


def ura_positions(rows: int, cols: int, spacing: float = 0.5) -> np.ndarray:
    """Uniform rectangular array (e.g. the 7x3 URA of the published
    measurements, measurement_script.m:3-23); returns [rows*cols, 2]."""
    x, y = np.meshgrid(np.arange(cols), np.arange(rows))
    return np.stack(
        [x.ravel() * spacing, y.ravel() * spacing], axis=-1
    ).astype(np.float32)


def uv_grid(n_points: int = 100, extent: float = 1.0,
            device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Direction-cosine scan grid: [G, 2] flattened (u, v) plus the 1-D axis
    (for plotting), float32 on ``device``. G = n_points^2 — heatmap2d's
    100x100 scan."""
    ax = torch.linspace(-extent, extent, n_points, dtype=torch.float32,
                        device=check_device(device))
    u, v = torch.meshgrid(ax, ax, indexing="xy")
    return torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1), ax


def steering_vectors(positions, uv, device=None) -> torch.Tensor:
    """Far-field plane-wave steering matrix.

    positions: [N, 2] wavelengths; uv: [G, 2] direction cosines.
    Returns [G, N] complex64: a_g[n] = exp(+2*pi*i * p_n . uv_g)
    (heatmap2d.cpp:106-147 steering-vector scan), on ``device``, else on
    uv's (or positions') device. The phase p_n . uv_g is summed
    elementwise in float32, so no matmul precision setting reaches it.
    """
    dev = _device_of(uv, positions, device=device)
    p = as_tensor(positions, torch.float32, dev)
    g = as_tensor(uv, torch.float32, dev)
    dot = g[:, None, 0] * p[None, :, 0] + g[:, None, 1] * p[None, :, 1]   # [G, N]
    return _phasor(2.0 * math.pi * dot)


def nearfield_steering_vectors(positions, xyz, device=None) -> torch.Tensor:
    """Near-field (spherical wavefront) steering for source points ``xyz``
    [G, 3] in wavelengths (the VTC'21 near-field localization setting,
    README.md:48-50): exact per-element path delays."""
    dev = _device_of(xyz, positions, device=device)
    p = as_tensor(positions, torch.float32, dev)
    p3 = torch.cat([p, torch.zeros((p.shape[0], 1), dtype=p.dtype, device=dev)], dim=-1)
    g = as_tensor(xyz, torch.float32, dev)
    d = torch.linalg.vector_norm(g[:, None, :] - p3[None, :, :], dim=-1)   # [G, N]
    d = d - d[:, :1]   # relative to element 0
    return _phasor(-2.0 * math.pi * d)
