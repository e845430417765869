"""Beamforming / DOA spectra on the aligned receive matrix (port of
``coherent_rtlsdr_tpu/models/beamform.py``).

Covers (and extends) the reference's downstream consumers:
  * MUSIC pseudospectrum — beamformclient/heatmap2d.cpp:61-147 (SVD noise
    subspace + steering scan) and matlabclient/functions/pmusic.m
  * Bartlett (delay-and-sum) — the BASELINE.json "delay-and-sum heatmap"
  * MVDR/Capon — not in the reference; standard addition

Shapes: X [N, T] snapshots, R [N, N] covariance, A [G, N] steering matrix.
Complex64 products, one ``torch.linalg.eigh`` (MUSIC) or ``solve`` (MVDR),
on the device of the inputs; float32 products run without TF32 on the card
(``kernels/fft4step.exact_f32_matmul``). ESPRIT and root-MUSIC stay
host-side numpy, as in the JAX package.
"""

import numpy as np
import torch

from coherent_rtlsdr_tpu_torch.kernels.fft4step import exact_f32_matmul
from coherent_rtlsdr_tpu_torch.models.geometry import as_tensor, steering_vectors, uv_grid

C64 = torch.complex64


def sample_covariance(X, subtract_mean: bool = True) -> torch.Tensor:
    """R = X X^H / T, optionally mean-subtracted per channel
    (heatmap2d.cpp:61-69 subtracts the row mean before the outer product)."""
    X = as_tensor(X, C64)
    if subtract_mean:
        X = X - X.mean(dim=-1, keepdim=True)
    T = X.shape[-1]
    with exact_f32_matmul(X):
        return (X @ X.conj().T) / T


def _noise_subspace(R: torch.Tensor, n_sources: int) -> torch.Tensor:
    """Smallest-(N - n_sources) eigenvectors of Hermitian R.

    eigh returns ascending eigenvalues, so the noise subspace is the leading
    columns (heatmap2d.cpp uses an SVD; eigh of the Hermitian covariance is
    the equivalent). Each column is fixed only up to a phase, and within a
    degenerate noise eigenspace only the span is: compare projectors
    En En^H, never columns.
    """
    _, vecs = torch.linalg.eigh(R)
    n = R.shape[-1]
    return vecs[:, : n - n_sources]  # [N, N - K]


def music_spectrum(R, A, n_sources: int) -> torch.Tensor:
    """MUSIC pseudospectrum P[g] = (a^H a) / ||E_n^H a||^2."""
    R = as_tensor(R, C64)
    A = as_tensor(A, C64, R.device)
    En = _noise_subspace(R, n_sources)          # [N, M]
    with exact_f32_matmul(A):
        proj = A @ En.conj()                    # [G, M]
    denom = (proj.abs() ** 2).sum(dim=-1)
    num = (A.abs() ** 2).sum(dim=-1)
    return num / denom.clamp_min(1e-12)


def bartlett_spectrum(R, A) -> torch.Tensor:
    """Delay-and-sum power: P[g] = a^H R a, normalized by ||a||^2."""
    R = as_tensor(R, C64)
    A = as_tensor(A, C64, R.device)
    # a^H R a as a row-wise quadratic form: (A @ R.T)[g, n] = (R a_g)[n].
    with exact_f32_matmul(A):
        q = (A.conj() * (A @ R.T)).sum(dim=-1)
    norm = (A.abs() ** 2).sum(dim=-1)
    return q.real / norm.clamp_min(1e-12)


def mvdr_spectrum(R, A, diag_load: float = 1e-3) -> torch.Tensor:
    """Capon/MVDR: P[g] = 1 / (a^H R^-1 a), with diagonal loading."""
    R = as_tensor(R, C64)
    A = as_tensor(A, C64, R.device)
    N = R.shape[-1]
    tr = R.diagonal().sum().real / N
    Rl = R + diag_load * tr * torch.eye(N, dtype=R.dtype, device=R.device)
    Rinv_A = torch.linalg.solve(Rl, A.T)                 # columns R^-1 a_g
    q = (A.T.conj() * Rinv_A).sum(dim=0).real            # a^H R^-1 a
    return 1.0 / q.clamp_min(1e-12)


def _host(R) -> np.ndarray:
    return R.detach().cpu().numpy() if torch.is_tensor(R) else np.asarray(R)


def esprit_doa(R, n_sources: int, d: float = 0.5):
    """LS-ESPRIT for a uniform linear array — GRIDLESS DOA, beyond the
    reference's grid-scan estimators (pmusic.m / heatmap2d scan a fixed
    (u, v) grid; ESPRIT reads the angles straight out of the rotational
    invariance between the two N-1-element subarrays).

    ``d`` is the element spacing in wavelengths; steering convention
    a(theta)_n = exp(+j 2 pi d n sin(theta)) (models/geometry.py).
    Returns sorted DOAs in radians. Host-side numpy on R (a tensor on any
    device, or an array), as in the JAX package and the reference's MATLAB
    functions: the final [K, K] non-Hermitian eigenvalue problem is a few
    microseconds of host work on a client-side covariance.
    """
    R = _host(R)
    if not 0 < n_sources < R.shape[-1]:
        raise ValueError(f"n_sources must be in (0, N={R.shape[-1]})")
    _, vecs = np.linalg.eigh(R)
    Es = vecs[:, -n_sources:]                     # signal subspace [N, K]
    Psi, *_ = np.linalg.lstsq(Es[:-1], Es[1:], rcond=None)
    phi = np.angle(np.linalg.eigvals(Psi))
    return np.sort(np.arcsin(np.clip(phi / (2 * np.pi * d), -1.0, 1.0)))


def root_music_doa(R, n_sources: int, d: float = 0.5):
    """root-MUSIC for a uniform linear array — the gridless form of the
    MUSIC spectrum: the noise-subspace projector's diagonal-sum polynomial
    is rooted and the K roots nearest (inside) the unit circle give the
    DOAs. Same conventions/returns as :func:`esprit_doa`; host-side numpy
    (``np.roots``), as in the JAX package."""
    R = _host(R)
    N = R.shape[0]
    if not 0 < n_sources < N:
        raise ValueError(f"n_sources must be in (0, N={N})")
    _, vecs = np.linalg.eigh(R)
    En = vecs[:, : N - n_sources]
    C = En @ En.conj().T
    coeffs = np.array([np.trace(C, offset=k) for k in range(N - 1, -N, -1)])
    roots = np.roots(coeffs)
    roots = roots[np.abs(roots) < 1.0]
    pick = roots[np.argsort(1.0 - np.abs(roots))[:n_sources]]
    phi = np.angle(pick)
    return np.sort(np.arcsin(np.clip(phi / (2 * np.pi * d), -1.0, 1.0)))


def music_heatmap(
    X,
    positions,
    n_sources: int,
    n_points: int = 100,
    extent: float = 1.0,
) -> torch.Tensor:
    """End-to-end heatmap2d equivalent: snapshots -> [n_points, n_points]
    MUSIC surface over the (u, v) grid, on X's device."""
    R = sample_covariance(X)
    uv, _ = uv_grid(n_points, extent, device=R.device)
    A = steering_vectors(positions, uv)
    P = music_spectrum(R, A, n_sources)
    return P.reshape(n_points, n_points)
