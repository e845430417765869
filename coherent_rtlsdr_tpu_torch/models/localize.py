"""Near-field source localization on the aligned receive matrix (port of
``coherent_rtlsdr_tpu/models/localize.py``).

The reference authors' second published use case (VTC'21 near-field
localization, README.md:48-50): with a large-aperture array and a close
emitter, the wavefront curvature encodes range as well as bearing. Here:

  * ``nearfield_music``: MUSIC pseudospectrum over a 3-D (x, y, z) candidate
    grid using exact spherical-wave steering vectors;
  * ``ml_localize``: deterministic maximum-likelihood grid search — the
    single-source ML estimate is the grid point whose steering vector
    maximizes the beamformed energy a^H R a / ||a||^2 (equivalently the
    matched-field processor).

Batched products over the candidate grid, on the device of the snapshots.
"""

from typing import Tuple

import numpy as np
import torch

from coherent_rtlsdr_tpu_torch.kernels.fft4step import exact_f32_matmul
from coherent_rtlsdr_tpu_torch.models.beamform import music_spectrum, sample_covariance
from coherent_rtlsdr_tpu_torch.models.geometry import (
    as_tensor,
    check_device,
    nearfield_steering_vectors,
)


def make_xyz_grid(
    x_range: Tuple[float, float],
    y_range: Tuple[float, float],
    z_range: Tuple[float, float],
    n: Tuple[int, int, int],
    device="cuda",
) -> torch.Tensor:
    """Candidate source positions [G, 3] in wavelengths, float32 on
    ``device``."""
    dev = check_device(device)
    xs, ys, zs = (torch.linspace(*r, k, dtype=torch.float32, device=dev)
                  for r, k in zip((x_range, y_range, z_range), n))
    X, Y, Z = torch.meshgrid(xs, ys, zs, indexing="ij")
    return torch.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], dim=-1)


def nearfield_music(
    X,                       # [N, T] aligned snapshots
    positions: np.ndarray,   # [N, 2] element positions (wavelengths)
    grid,                    # [G, 3] candidate positions
    n_sources: int = 1,
) -> torch.Tensor:
    """MUSIC over the near-field grid; returns [G]."""
    R = sample_covariance(X)
    A = nearfield_steering_vectors(positions, grid, device=R.device)  # [G, N]
    return music_spectrum(R, A, n_sources)


def ml_localize(X, positions: np.ndarray, grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-source ML (matched-field) location estimate.

    Returns ``(xyz_hat [3], spectrum [G])``. The estimate is the argmax of
    the normalized beamformer output over the grid (the first grid point
    where the maximum is tied, as ``jnp.argmax`` takes it).
    """
    R = sample_covariance(X)
    grid = as_tensor(grid, torch.float32, R.device)
    A = nearfield_steering_vectors(positions, grid)  # [G, N]
    with exact_f32_matmul(A):
        q = (A.conj() * (A @ R.T)).sum(dim=-1).real
    norm = (A.abs() ** 2).sum(dim=-1)
    spec = q / norm.clamp_min(1e-12)
    idx = torch.argmax(spec)
    return grid[idx], spec
