"""Difference co-array processing for sparse arrays (port of
``coherent_rtlsdr_tpu/models/coarray.py``).

The reference's sparse-array pipeline (matlabclient/functions/darray.m,
DA2D.m, D2Dtoepos.m; the EUSIPCO'20 paper, README.md:44-47): a sparse
physical array on an integer grid has a *difference co-array* — the set of
pairwise position differences — that can be much larger than N, letting
MUSIC resolve more sources than sensors via an augmented covariance whose
entries are co-array-lag averages of the physical covariance.

Positions here are integer grid coordinates (the reference's "Gaussian
integer" representation of 2D lags is just the same 2D integer lattice).
The lag bookkeeping is numpy, as in the JAX package; the averages are
tensors on R's device.
"""

from typing import Tuple

import numpy as np
import torch

from coherent_rtlsdr_tpu_torch.kernels.fft4step import exact_f32_matmul
from coherent_rtlsdr_tpu_torch.models.beamform import music_spectrum
from coherent_rtlsdr_tpu_torch.models.geometry import as_tensor, steering_vectors


def difference_coarray(grid_positions: np.ndarray) -> np.ndarray:
    """All pairwise differences of integer grid positions [N, 2] ->
    unique lags [M, 2] (darray.m analog)."""
    p = np.asarray(grid_positions, np.int64)
    diffs = (p[:, None, :] - p[None, :, :]).reshape(-1, 2)
    return np.unique(diffs, axis=0)


def _lag_index_map(grid_positions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """For each (i, j) sensor pair, the flat index of its co-array lag, plus
    per-lag pair counts (for averaging)."""
    p = np.asarray(grid_positions, np.int64)
    n = len(p)
    diffs = (p[:, None, :] - p[None, :, :]).reshape(-1, 2)
    lags, inverse = np.unique(diffs, axis=0, return_inverse=True)
    counts = np.bincount(inverse, minlength=len(lags))
    return inverse.reshape(n, n), counts, len(lags)


def coarray_covariance_lags(R, grid_positions: np.ndarray) -> Tuple[torch.Tensor, np.ndarray]:
    """Average the physical covariance over equal co-array lags (DA2D.m):
    returns (r_lags [M] complex, lags [M, 2] int).

    The sums are one product of a [M, N^2] 0/1 pair-to-lag matrix with the
    flattened R, so every run adds in the same order (a scatter-add on the
    card adds atomically, in no fixed order)."""
    inverse, counts, m = _lag_index_map(grid_positions)
    R = as_tensor(R, torch.complex64)
    flat = inverse.reshape(-1)
    pairs = np.zeros((m, flat.size), np.complex64)
    pairs[flat, np.arange(flat.size)] = 1
    with exact_f32_matmul(R):
        sums = torch.as_tensor(pairs, device=R.device) @ R.reshape(-1)
    r = sums / torch.as_tensor(counts, dtype=torch.float32, device=R.device)
    lags = difference_coarray(grid_positions)
    return r, lags


def virtual_ura(box: Tuple[int, int], spacing: float = 0.5) -> np.ndarray:
    """Element positions (wavelengths) of the filled virtual URA that
    :func:`augmented_covariance` synthesizes, in ITS element order."""
    bx, by = box
    return np.asarray(
        [(x * spacing, y * spacing) for y in range(by) for x in range(bx)],
        np.float32,
    )


def coarray_music_spectrum(
    R,
    grid_positions: np.ndarray,
    box: Tuple[int, int],
    uv,
    n_sources: int,
    spacing: float = 0.5,
) -> torch.Tensor:
    """Sparse-array MUSIC via direct augmentation (the reference authors'
    EUSIPCO'20 pipeline: darray.m -> DA2D.m -> pmusic.m with co-array
    processing, matlabclient/functions/pmusic.m:19-25): average the physical
    covariance over co-array lags, rebuild the filled virtual-URA covariance,
    and scan MUSIC on the VIRTUAL array — resolving more sources than
    physical sensors (up to bx*by - 1)."""
    Ra = augmented_covariance(R, grid_positions, box)
    A = steering_vectors(virtual_ura(box, spacing), uv, device=Ra.device)
    return music_spectrum(Ra, A, n_sources)


def augmented_covariance(R, grid_positions: np.ndarray, box: Tuple[int, int]) -> torch.Tensor:
    """Direct-augmentation covariance over a filled (bx x by) virtual URA
    contained in the co-array (D2Dtoepos.m analog).

    Virtual element (x, y) for x in [0,bx), y in [0,by); entry [a, b] of the
    augmented matrix is the averaged co-array statistic at lag
    pos_a - pos_b. Requires every needed lag to exist in the co-array (true
    whenever the physical array spans the box corners).
    """
    r, lags = coarray_covariance_lags(R, grid_positions)
    lag_lookup = {tuple(l): i for i, l in enumerate(np.asarray(lags))}

    bx, by = box
    virt = [(x, y) for y in range(by) for x in range(bx)]
    m = len(virt)
    idx = np.zeros((m, m), np.int64)
    for a, pa in enumerate(virt):
        for b, pb in enumerate(virt):
            lag = (pa[0] - pb[0], pa[1] - pb[1])
            if lag not in lag_lookup:
                raise ValueError(f"co-array missing lag {lag} for box {box}")
            idx[a, b] = lag_lookup[lag]
    return r[torch.as_tensor(idx, device=r.device)]
