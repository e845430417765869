"""The port's spectral ops, lag estimators, permuted-layout ops and
four-step FFTs against the JAX package's, on the same numpy-made inputs
(CPU; the JAX package's Pallas four-step runs in interpret mode).

Bars, and why:
  * lag estimates where the channel correlates (mag >= 0.1): lag atol 2e-3
    samples, mag rtol 1e-3, papr rtol 1e-2 (tests/test_kernels.py:143-147);
    float32 sums run in other orders in the two libraries.
  * exact integer ramps bit for bit; ramps and spectra within float32
    rounding (atol 1e-5 or tighter, stated at each check).
  * the plain bf16 four-step against the Pallas kernel: max |diff| / max
    |Pallas| < 1e-3 (the same bf16 casts on both sides; summation order can
    flip the bf16 rounding of an element of C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.kernels import fft4step as jfft
from coherent_rtlsdr_tpu.kernels import permuted as jperm
from coherent_rtlsdr_tpu.kernels.pallas_fft import FFT4StepPallas
from coherent_rtlsdr_tpu.ops import convert as jconv
from coherent_rtlsdr_tpu.ops import delay as jdelay
from coherent_rtlsdr_tpu.ops import spectral as jspec
from coherent_rtlsdr_tpu.ops import xcorr as jxcorr
from coherent_rtlsdr_tpu_torch.kernels import fft4step as tfft
from coherent_rtlsdr_tpu_torch.kernels import permuted as tperm
from coherent_rtlsdr_tpu_torch.kernels.fourstep import FFT4StepKernel
from coherent_rtlsdr_tpu_torch.ops import convert as tconv
from coherent_rtlsdr_tpu_torch.ops import delay as tdelay
from coherent_rtlsdr_tpu_torch.ops import spectral as tspec
from coherent_rtlsdr_tpu_torch.ops import xcorr as txcorr

W = 4096
M = 64
MIN_CORR_MAG = 0.1


def _c64(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale).astype(
        np.complex64)


def _to_permuted(X):
    """Natural-order spectrum [.., W] -> the four-step (k2, k1) layout."""
    return np.swapaxes(X.reshape(*X.shape[:-1], M, M), -1, -2).copy()


def _spectra(seed):
    """F_sig [5, W]: fractionally delayed, noisy copies of a Gaussian
    reference (lags 4.25, -33.7, 0, 200.4, within the phase_zoom range W/16) and one uncorrelated channel;
    F_ref [W]."""
    rng = np.random.default_rng(seed)
    F_ref = np.fft.fft(_c64(rng, (W,)))
    lags = np.array([4.25, -33.7, 0.0, 200.4])
    f = np.fft.fftfreq(W)
    F_sig = F_ref[None] * np.exp(-2j * np.pi * f[None] * lags[:, None])
    F_sig = np.concatenate([F_sig + np.fft.fft(_c64(rng, (4, W), 0.1)),
                            np.fft.fft(_c64(rng, (1, W)))])
    return F_sig.astype(np.complex64), F_ref.astype(np.complex64)


def _assert_estimate_close(t, j):
    """t, j: (lag, mag, papr) as numpy; held where the channel correlates,
    and the same accept/reject decision everywhere."""
    used = j[1] >= MIN_CORR_MAG
    np.testing.assert_array_equal(t[1] >= MIN_CORR_MAG, used)
    np.testing.assert_allclose(t[0][used], j[0][used], atol=2e-3)
    np.testing.assert_allclose(t[1][used], j[1][used], rtol=1e-3)
    np.testing.assert_allclose(t[2][used], j[2][used], rtol=1e-2)
    return used


@pytest.mark.parametrize("valid_corr_len", [None, 1024])
@pytest.mark.parametrize("method", ["phase_slope", "parabolic", "integer", "phase_zoom"])
def test_lag_estimate_from_spectra_matches_jax(method, valid_corr_len):
    F_sig, F_ref = _spectra(1)
    j = jxcorr.lag_estimate_from_spectra(jnp.asarray(F_sig), jnp.asarray(F_ref),
                                         valid_corr_len=valid_corr_len, method=method)
    t = txcorr.lag_estimate_from_spectra(torch.from_numpy(F_sig), torch.from_numpy(F_ref),
                                         valid_corr_len=valid_corr_len, method=method)
    used = _assert_estimate_close([x.numpy() for x in t], [np.asarray(x) for x in j])
    assert used.tolist() == [True] * 4 + [False]
    # Leading batch dimensions, where the JAX package vmaps.
    tb = txcorr.lag_estimate_from_spectra(torch.from_numpy(np.stack([F_sig, F_sig[::-1]])),
                                          torch.from_numpy(np.stack([F_ref, F_ref])),
                                          valid_corr_len=valid_corr_len, method=method)
    for a, b in zip(tb, t):
        np.testing.assert_allclose(a[0].numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_lag_estimate_wrappers_match_jax():
    rng = np.random.default_rng(2)
    ref = _c64(rng, (W,))
    sig = np.roll(ref, 7)[None] + _c64(rng, (2, W), 0.1)
    j = jxcorr.lag_estimate_batched(jnp.asarray(sig), jnp.asarray(ref))
    t = txcorr.lag_estimate_batched(torch.from_numpy(sig), torch.from_numpy(ref))
    _assert_estimate_close([x.numpy() for x in t], [np.asarray(x) for x in j])
    j1 = jxcorr.lag_estimate(jnp.asarray(sig[0]), jnp.asarray(ref), fft_len=2 * W)
    t1 = txcorr.lag_estimate(torch.from_numpy(sig[0]), torch.from_numpy(ref), fft_len=2 * W)
    np.testing.assert_allclose(float(t1.lag), float(j1.lag), atol=2e-3)
    np.testing.assert_allclose(
        txcorr.xcorr_circular(torch.from_numpy(sig), torch.from_numpy(ref)).numpy(),
        np.asarray(jxcorr.xcorr_circular(jnp.asarray(sig), jnp.asarray(ref))),
        atol=2e-3)
    y = rng.standard_normal((3, 5)).astype(np.float32)
    y[0, :] = 1.0   # flat: the zero-denominator branch
    np.testing.assert_allclose(
        txcorr.parabolic_peak_offset(*(torch.from_numpy(r) for r in y)).numpy(),
        np.asarray(jxcorr.parabolic_peak_offset(*(jnp.asarray(r) for r in y))), atol=1e-6)


@pytest.mark.parametrize("method", ["phase_slope", "integer"])
def test_lag_estimate_permuted_matches_jax(method):
    F_sig, F_ref = _spectra(3)
    P_sig, P_ref = _to_permuted(F_sig), _to_permuted(F_ref)
    j = jperm.lag_estimate_permuted(jfft.FFT4Step(W, precision="f32"), jnp.asarray(P_sig),
                                    jnp.asarray(P_ref), method=method)
    fft = tfft.FFT4Step(W, "cpu", precision="f32")
    t = tperm.lag_estimate_permuted(fft, torch.from_numpy(P_sig), torch.from_numpy(P_ref),
                                    method=method)
    _assert_estimate_close([x.numpy() for x in t], [np.asarray(x) for x in j])
    with pytest.raises(ValueError, match="unsupported method"):
        tperm.lag_estimate_permuted(fft, torch.from_numpy(P_sig), torch.from_numpy(P_ref),
                                    method="parabolic")


def test_integer_ramp_grid_is_exact():
    """(k d) mod W on the permuted grid, bit for bit, for |d| up to W and
    either sign."""
    d = np.concatenate([np.arange(-W, W + 1, 37), [-W, -W + 1, -1, 0, 1, W - 1, W]])
    d = d.astype(np.float32)
    j = jperm._integer_ramp_phase_grid(jfft.FFT4Step(W), jnp.asarray(d))
    t = tperm._integer_ramp_phase_grid(tfft.FFT4Step(W, "cpu"), torch.from_numpy(d))
    np.testing.assert_array_equal(t.numpy().view(np.int32), np.asarray(j).view(np.int32))
    j1 = jdelay._integer_delay_ramp_phase(W, jnp.asarray(d))
    t1 = tdelay._integer_delay_ramp_phase(W, torch.from_numpy(d))
    np.testing.assert_array_equal(t1.numpy().view(np.int32), np.asarray(j1).view(np.int32))


def test_permuted_ramps_match_jax():
    d = np.array([0.0, 3.25, -117.5, 1000.0, -2047.875], np.float32)
    jf, tf = jfft.FFT4Step(W), tfft.FFT4Step(W, "cpu")
    rj = np.asarray(jperm.delay_ramp_permuted(jf, jnp.asarray(d)))
    rt = tperm.delay_ramp_permuted(tf, torch.from_numpy(d)).numpy()
    assert np.abs(rt - rj).max() < 1e-4
    # ... and equal the natural-order ramp, permuted (tests/test_kernels.py:124-129).
    rn = _to_permuted(tdelay.delay_ramp(W, torch.from_numpy(d)).numpy())
    assert np.abs(rt - rn).max() < 1e-4
    rng = np.random.default_rng(4)
    Fp, ph = _c64(rng, (5, M, M)), np.exp(1j * rng.uniform(-3, 3, 5)).astype(np.complex64)
    np.testing.assert_allclose(
        tperm.apply_delay_phase_permuted(tf, torch.from_numpy(Fp), torch.from_numpy(d),
                                         torch.from_numpy(ph)).numpy(),
        np.asarray(jperm.apply_delay_phase_permuted(jf, jnp.asarray(Fp), jnp.asarray(d),
                                                    jnp.asarray(ph))), atol=5e-4)


def test_delay_ops_match_jax():
    rng = np.random.default_rng(5)
    F, hist, cur = _c64(rng, (3, W)), _c64(rng, (3, W // 2)), _c64(rng, (3, W // 2))
    adv = np.array([0.5, -12.25, 300.0], np.float32)
    ph = np.exp(1j * np.array([0.1, -2.0, 3.0])).astype(np.complex64)
    np.testing.assert_allclose(
        tdelay.apply_delay_phase_freq(torch.from_numpy(F), torch.from_numpy(adv),
                                      torch.from_numpy(ph)).numpy(),
        np.asarray(jdelay.apply_delay_phase_freq(jnp.asarray(F), jnp.asarray(adv),
                                                 jnp.asarray(ph))), atol=5e-4)
    th, to = tdelay.overlap_save_advance(*(torch.from_numpy(x) for x in (hist, cur, adv, ph)))
    jh, jo = jdelay.overlap_save_advance(*(jnp.asarray(x) for x in (hist, cur, adv, ph)))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert to.dtype == torch.complex64
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)


def test_spectral_ops_match_jax():
    rng = np.random.default_rng(6)
    z = _c64(rng, (3, 100))
    r = rng.standard_normal((3, 100)).astype(np.float32)
    r[1] = 0.0   # the zero-RMS / zero-mean branches
    for x in (z, r):
        for name in ("rms", "crest_factor", "papr"):
            np.testing.assert_allclose(getattr(tspec, name)(torch.from_numpy(x)).numpy(),
                                       np.asarray(getattr(jspec, name)(jnp.asarray(x))),
                                       rtol=2e-6, err_msg=name)
    np.testing.assert_allclose(tspec.magsquared(torch.from_numpy(z)).numpy(),
                               np.asarray(jspec.magsquared(jnp.asarray(z))), rtol=1e-6)
    np.testing.assert_allclose(tspec.conj_dot(torch.from_numpy(z), torch.from_numpy(z[::-1].copy())).numpy(),
                               np.asarray(jspec.conj_dot(jnp.asarray(z), jnp.asarray(z[::-1]))),
                               rtol=1e-5)
    u8 = rng.integers(0, 256, (3, 64, 2), dtype=np.uint8)
    np.testing.assert_array_equal(tconv.u8_to_c64(torch.from_numpy(u8)).numpy(),
                                  np.asarray(jconv.u8_to_c64(jnp.asarray(u8))))


def test_fft4step_f32_matches_jax():
    rng = np.random.default_rng(7)
    x = _c64(rng, (3, W))
    jf, tf = jfft.FFT4Step(W, precision="f32"), tfft.FFT4Step(W, "cpu", precision="f32")
    Xj = np.array(jf.fft(jnp.asarray(x)))
    Xt = tf.fft(torch.from_numpy(x)).numpy()
    assert np.abs(Xt - Xj).max() / np.abs(Xj).max() < 1e-5
    # f32 is the exact transform to float32 rounding (tests/test_kernels.py:41-48).
    assert np.abs(Xt - _to_permuted(np.fft.fft(x))).max() / np.abs(Xj).max() < 2e-5
    xt = tf.ifft(torch.from_numpy(Xj)).numpy()
    xj = np.asarray(jf.ifft(jnp.asarray(Xj)))
    assert np.abs(xt - xj).max() / np.abs(xj).max() < 1e-5
    with pytest.raises(ValueError, match="precision"):
        tfft.FFT4Step(W, "cpu", precision="f16")


@pytest.mark.parametrize("tile", [1, 8])
def test_fourstep_plain_matches_pallas(tile):
    """The plain version of the four-step kernel (FFT4Step at bf16) against
    the JAX package's Pallas kernel, both tile settings."""
    rng = np.random.default_rng(8)
    x = _c64(rng, (16, W))
    jp = FFT4StepPallas(W, tile=tile)
    k = FFT4StepKernel(W, "cpu")
    Xj = np.array(jp.fft(jnp.asarray(x)))
    Xt = k.fft(torch.from_numpy(x)).numpy()
    assert Xt.shape == (16, M, M)
    assert np.abs(Xt - Xj).max() / np.abs(Xj).max() < 1e-3
    # [..., m, m] input is accepted, as the Pallas wrapper does.
    assert np.array_equal(k.fft(torch.from_numpy(x.reshape(16, M, M))).numpy(), Xt)
    xj = np.asarray(jp.ifft(jnp.asarray(Xj)))
    xt = k.ifft(torch.from_numpy(Xj)).numpy()
    assert xt.shape == (16, W)
    assert np.abs(xt - xj).max() / np.abs(xj).max() < 1e-3
    assert k.counts() == dict(fft_launches=0, ifft_launches=0, fft_plain_runs=2,
                              ifft_plain_runs=1)
