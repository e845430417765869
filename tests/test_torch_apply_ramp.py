"""The persistent apply kernel's ramp at m in {64, 128} as
``csrc/fused_apply.cu:ramp_phasors`` splits it, written out in float64
numpy, against the plain version's per-element ramp
(``FusedPipelineKernels._ramp``, as ``apply_spec_i8_plain`` uses it) times
the phase factor.

For natural bin k = r + m c (row r = k2, column c = k1 of the permuted
layout) and the delay d = -advance = di + df (di = floor(d)), the kernel
builds the window's weight as a row phasor times a column phasor:

  * e^{-2 pi i k di / W} = e^{-2 pi i r di / W} e^{-2 pi i c di / m}, each
    from an exact integer residue;
  * e^{-2 pi i f_k df} = e^{-2 pi i r df / W} e^{-2 pi i c_s df / m}, c_s
    the signed column (c - m from the Nyquist column c = m/2 on, where
    k >= W/2 and f_k = (k - W) / W);
  * the phase factor folded into the row phasor.

Bar: 1e-5, the float32 rounding of the plain version's phase (up to 1.5
turns, 2 pi times an ulp of ~9.4). The same split with the unsigned column
c in place of c_s misses it by the Nyquist half's e^{-2 pi i df} wherever
the delay has a fractional part.
"""

import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels

ADVANCES = [0.0, 0.37, -3.8, -1500.25, 1023.5]


def _kernel_weight(m, advance, phase, signed=True):
    """The kernel's weight complex128 [m, m] (rows r, columns c): row
    phasor (times the phase factor) times column phasor."""
    W = m * m
    d = -np.float32(advance)
    di = np.floor(d)
    df = float(np.float32(d - di))
    d_int = int(di)
    x = np.arange(m)
    cs = np.where(x < m // 2, x, x - m) if signed else x
    row = np.exp(-2j * np.pi * ((x * d_int) % W / W + x * df / W)) * phase
    col = np.exp(-2j * np.pi * ((x * d_int) % m / m + cs * df / m))
    return row[:, None] * col[None, :]


def _plain_weight(k, advance, phase):
    """The plain version's ramp at this advance times the phase factor."""
    wr, wi = k._ramp(torch.tensor([advance], dtype=torch.float32))
    return (wr[0].double().numpy() + 1j * wi[0].double().numpy()) * phase


@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("advance", ADVANCES)
def test_phasor_ramp_matches_plain(m, advance):
    k = FusedPipelineKernels(m * m, "cpu")
    phase = np.exp(1j * np.float32(0.7 + advance))
    got = _kernel_weight(m, advance, phase)
    want = _plain_weight(k, advance, phase)
    # every column, the straddle c = m/2 - 1, m/2 among them
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(got[:, m // 2 - 1: m // 2 + 1] - want[:, m // 2 - 1: m // 2 + 1]).max() <= 1e-5


@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("advance", [a for a in ADVANCES if a != np.floor(a)])
def test_unsigned_column_misses_plain(m, advance):
    """The split with the unsigned column is off by e^{-2 pi i df} from the
    Nyquist column on, and right below it, so the bar above catches it."""
    k = FusedPipelineKernels(m * m, "cpu")
    got = _kernel_weight(m, advance, 1.0, signed=False)
    want = _plain_weight(k, advance, 1.0)
    err = np.abs(got - want).max(axis=0)
    assert err[: m // 2].max() <= 1e-5
    assert err[m // 2:].min() > 1e-2
