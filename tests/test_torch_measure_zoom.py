"""The channel kernels' phase zoom at m in {64, 128} as
``csrc/fused_measure.cu:channel_window`` splits it, written out in float64
numpy, against the plain version's zoom (``FusedPipelineKernels``, whose
outputs the kernels are held to on the card) on the same cross-spectra:

  * stage 1's 8-row bands summed per 16-row strip (the epilogue's lanes),
    their products within a strip, with the strip above's last band, and
    across the column boundary on the first strip but at the Nyquist
    straddle;
  * the integer deramp as a row phasor times a column phasor, and the
    fractional zoom as a row phasor times a signed-column phasor, each
    folded into one pass over G.

G is the cross-spectrum of a window delayed by a known lag, in the
permuted (k2, k1) layout: G[r, c] = A e^{-2 pi i f tau} + noise at natural
bin k = r + m c, f its signed frequency. Bars: the lag within 2e-5
samples and z within 1e-6 of |z| of the plain version's (float32 sums,
float64 here); both within 0.02 samples of the lag put in.
"""

import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels


def _cross_spectrum(m, tau, seed):
    """G float64 complex [m, m] of a window delayed by tau samples."""
    W = m * m
    rng = np.random.default_rng(seed)
    k = np.arange(m)[:, None] + m * np.arange(m)[None, :]
    f = np.where(k < W // 2, k, k - W) / W
    amp = rng.uniform(0.5, 1.5, (m, m))
    noise = 0.1 * (rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m)))
    return amp * np.exp(-2j * np.pi * f * tau) * np.exp(1j * rng.uniform(-np.pi, np.pi)) + noise


def _kernel_zoom(G, m):
    """(lag, z) as channel_window computes them, in float64."""
    W = m * m
    bands = G.reshape(m // 8, 8, m).sum(1)            # [band j, column c]
    s1 = 0j
    for w in range(m // 16):                          # a strip's epilogue: bands 2w, 2w + 1
        s1 += (bands[2 * w + 1] * bands[2 * w].conj()).sum()
        if w > 0:                                     # with the strip above's last band
            s1 += (bands[2 * w] * bands[2 * w - 1].conj()).sum()
    c = np.arange(1, m)                               # the first strip, across columns
    s1 += (bands[0, c] * bands[-1, c - 1].conj())[c - 1 != m // 2 - 1].sum()
    int_lag = np.round(-np.angle(s1) * (W / 8) / (2 * np.pi))

    d = -int(int_lag)
    r = np.arange(m)
    row = np.exp(2j * np.pi * ((r * d) % W) / W)      # e^{2 pi i r d / W}
    col = np.exp(2j * np.pi * ((r * d) % m) / m)      # e^{2 pi i c d / m}
    cols = (G * row.conj()[:, None]).sum(0) * col.conj()
    g2 = cols.reshape(m // 2, 2).sum(1)
    p2 = g2[1:] * g2[:-1].conj()
    p2[m // 4 - 1] = 0.0                              # the Nyquist pair
    frac = np.clip(-np.angle(p2.sum()) * (m / 2) / (2 * np.pi), -4.0, 4.0)

    cs = np.where(r < m // 2, r, r - m)               # the signed column
    prow = row.conj() * np.exp(2j * np.pi * frac * r / W)
    pcol = col.conj() * np.exp(2j * np.pi * frac * cs / m)
    z = ((G * prow[:, None]).sum(0) * pcol).sum()
    return int_lag + frac, z


@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("tau", [0.0, 3.37, -17.81, 200.45, -255.5])
def test_kernel_zoom_matches_plain(m, tau):
    G = _cross_spectrum(m, tau, seed=m + int(abs(tau) * 100))
    k = FusedPipelineKernels(m * m, "cpu")
    lag, zre, zim, _ = k._phase_zoom(torch.from_numpy(G.real.astype(np.float32)),
                                     torch.from_numpy(G.imag.astype(np.float32)))
    got_lag, got_z = _kernel_zoom(G, m)
    z = complex(zre.item(), zim.item())
    assert abs(got_lag - lag.item()) <= 2e-5
    assert abs(got_z - z) <= 1e-6 * abs(z)
    assert abs(got_lag - tau) <= 0.02
