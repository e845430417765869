"""The port's spectral backends (``kernels/backend.py``) against the JAX
package's, prepare -> measure -> correct on the same complex blocks (CPU:
the port runs its plain versions, the JAX package its Pallas kernels in
interpret mode). The fused backend's float measure/apply (the plain
versions of the CUDA kernels fused_measure_planes / fused_apply_planes) are
also held directly to the JAX ``FusedPipelineKernels.measure`` / ``.apply``.

Bars, and why:
  * measure, where the channel correlates (mag >= 0.1): lag atol 2e-3
    samples, mag rtol 1e-3, papr rtol 1e-2 (tests/test_kernels.py:143-147);
    the float measure kernel's own outputs (lag atol 1e-3; |z|, sum |D|^2,
    sum |G|^2 rtol 1e-3) at the bars of the i8 kernels
    (tests/test_torch_fused.py); the same accept/reject decision everywhere.
  * correct / apply: max |diff| <= 2/127 and under 1e-3 of the samples more
    than 1/127 apart - the int8 wire bars (tests/test_kernels.py:443-450)
    in float units.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.kernels import backend as jback
from coherent_rtlsdr_tpu.kernels.pallas_fused import FusedPipelineKernels as JaxKernels
from coherent_rtlsdr_tpu_torch.kernels import backend as tback
from coherent_rtlsdr_tpu_torch.kernels.fft4step import FFT4Step
from coherent_rtlsdr_tpu_torch.kernels.fourstep import FFT4StepKernel, get_fourstep_kernel
from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels, get_fused_kernels
from coherent_rtlsdr_tpu_torch.pipeline import align_offline, init_state, step
from coherent_rtlsdr_tpu_torch.pipeline.state import PipelineConfig, state_from_numpy

W = 4096
L = W // 2
T, N = 4, 4
MIN_CORR_MAG = 0.1


def _blocks(seed):
    """A continuous stream cut into blocks: sig [T, N, L] (three delayed,
    rotated, noisy copies of the reference, and one uncorrelated channel),
    ref [T, L], complex64."""
    rng = np.random.default_rng(seed)
    n = T * L
    c = lambda *s: rng.standard_normal(s) + 1j * rng.standard_normal(s)
    ref = c(n) * 0.25
    f = np.fft.fftfreq(n)
    lags = np.array([4.25, -33.7, 0.5])
    sig = np.fft.ifft(np.fft.fft(ref)[None] * np.exp(-2j * np.pi * f[None] * lags[:, None]))
    sig = sig * np.exp(1j * rng.uniform(-np.pi, np.pi, 3))[:, None] + 0.01 * c(3, n)
    sig = np.concatenate([sig, 0.25 * c(1, n)])
    return (sig.reshape(N, T, L).transpose(1, 0, 2).astype(np.complex64).copy(),
            ref.reshape(T, L).astype(np.complex64))


def _assert_estimate_close(t, j):
    used = j[1] >= MIN_CORR_MAG
    np.testing.assert_array_equal(t[1] >= MIN_CORR_MAG, used)
    np.testing.assert_allclose(t[0][used], j[0][used], atol=2e-3)
    np.testing.assert_allclose(t[1][used], j[1][used], rtol=1e-3)
    np.testing.assert_allclose(t[2][used], j[2][used], rtol=1e-2)
    assert used[:, :3].all() and not used[:, 3].any()


def _assert_float_wire_close(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    assert d.max() <= 2 / 127, d.max()
    assert (d > 1 / 127).mean() < 1e-3, (d > 1 / 127).mean()


BACKENDS = {
    "xla": (lambda: jback.XlaSpectral(W), lambda: tback.XlaSpectral(W)),
    "mxu-f32": (lambda: jback.MxuSpectral(W, precision="f32"),
                lambda: tback.MxuSpectral(W, precision="f32", device="cpu")),
    "mxu-bf16": (lambda: jback.MxuSpectral(W, precision="bf16"),
                 lambda: tback.MxuSpectral(W, precision="bf16", device="cpu")),
    "pallas": (lambda: jback.MxuSpectral(W, pallas=True),
               lambda: tback.MxuSpectral(W, pallas=True, device="cpu")),
}


@pytest.mark.parametrize("name", list(BACKENDS))
def test_backend_matches_jax(name):
    sig, ref = _blocks(1)
    jsp, tsp = (make() for make in BACKENDS[name])
    jctx = jsp.prepare(jnp.asarray(sig), jnp.asarray(ref))
    tctx = tsp.prepare(torch.from_numpy(sig), torch.from_numpy(ref))
    je = jsp.measure(jctx, "phase_slope")
    te = tsp.measure(tctx, "phase_slope")
    assert tuple(te.lag.shape) == (T - 1, N)
    _assert_estimate_close([x.numpy() for x in te], [np.asarray(x) for x in je])
    adv = np.array(je.lag)
    yj = jsp.correct(jctx, jnp.asarray(adv))
    yt = tsp.correct(tctx, torch.from_numpy(adv))
    assert tuple(yt.shape) == (T - 1, N, L) and yt.dtype == torch.complex64
    _assert_float_wire_close(yt.numpy(), np.asarray(yj))
    # The lower-level ops agree with the pipeline interface.
    lt = tsp.lag_estimate(tctx.F_sig[0], tctx.F_ref[0], "phase_slope")
    np.testing.assert_array_equal(lt.lag.numpy(), te.lag[0].numpy())
    w = np.concatenate([sig[0], sig[1]], axis=-1)
    np.testing.assert_allclose(tsp.ifft(tsp.fft(torch.from_numpy(w))).numpy(), w, atol=2e-2)


@pytest.mark.parametrize("kind", ["stream", "random"])
def test_fused_backend_matches_jax(kind):
    """FusedSpectral, and under it the float measure/apply plain versions
    against the JAX kernels on the JAX backend's own bf16 planes."""
    sig, ref = _blocks(2)
    if kind == "random":
        sig = np.roll(sig, 1, axis=0)   # channel blocks out of step with the reference
    jsp, tsp = jback.FusedSpectral(W), tback.FusedSpectral(W, "cpu")
    jctx = jsp.prepare(jnp.asarray(sig), jnp.asarray(ref))
    tctx = tsp.prepare(torch.from_numpy(sig), torch.from_numpy(ref))
    for a, b in zip(tctx, jctx):
        diff = np.abs(a.float().numpy() - np.asarray(b.astype(jnp.float32)))
        assert diff.max() <= 1e-3 * np.abs(np.asarray(b.astype(jnp.float32))).max()
    je = jsp.measure(jctx, "phase_zoom")
    te = tsp.measure(tctx, "phase_zoom")
    j = [np.asarray(x) for x in je]
    used = j[1] >= MIN_CORR_MAG
    np.testing.assert_array_equal(te.mag.numpy() >= MIN_CORR_MAG, used)
    assert used[:, :3].all() if kind == "stream" else not used.any()
    np.testing.assert_allclose(te.lag.numpy()[used], j[0][used], atol=2e-3)
    np.testing.assert_allclose(te.mag.numpy()[used], j[1][used], rtol=1e-3)
    with pytest.raises(ValueError, match="phase_zoom"):
        tsp.measure(tctx, "phase_slope")

    # The kernels' plain versions on JAX's own planes.
    planes = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
              for x in jctx]
    k = FusedPipelineKernels(W, "cpu")
    got = [x.numpy() for x in k.measure(*planes)]
    want = [np.asarray(x) for x in JaxKernels(W).measure(*jctx)]
    assert k.counts()["measure_plain_runs"] == 1
    for x in got:
        assert x.shape == (T - 1, N) and np.isfinite(x).all()
    np.testing.assert_allclose(got[0][used], want[0][used], atol=1e-3)
    for name, a, b in zip(("|z|", "sum|D|^2", "sum|G|^2"), got[1:], want[1:]):
        np.testing.assert_allclose(a[used], b[used], rtol=1e-3, err_msg=name)

    adv = np.linspace(-40.25, 1500.5, (T - 1) * N).astype(np.float32).reshape(T - 1, N)
    yj = JaxKernels(W).apply(jctx.pre, jctx.pim, jnp.asarray(adv))
    yt = k.apply(planes[0], planes[1], torch.from_numpy(adv))
    assert k.counts()["apply_plain_runs"] == 1
    for a, b in zip(yt, yj):
        assert tuple(a.shape) == (T - 1, N, L)
        _assert_float_wire_close(a.numpy(), b)
    _assert_float_wire_close(tsp.correct(tctx, torch.from_numpy(adv)).numpy(),
                             np.asarray(jsp.correct(jctx, jnp.asarray(adv))))


def test_get_spectral_selection_matches_jax():
    from coherent_rtlsdr_tpu.pipeline.state import PipelineConfig as JaxConfig

    for impl in ("xla", "mxu", "pallas", "fused", "auto"):
        for L_ in (2048, 4096):
            cfg, jcfg = (C(n_channels=2, block_len=L_, fft_impl=impl)
                         for C in (PipelineConfig, JaxConfig))
            try:
                jsp = jback.get_spectral(jcfg, 2 * L_)
            except ValueError:
                with pytest.raises(ValueError, match="square"):
                    tback.get_spectral(cfg, 2 * L_, "cpu")
                continue
            tsp = tback.get_spectral(cfg, 2 * L_, "cpu")
            assert type(tsp).__name__ == type(jsp).__name__, (impl, L_)
            assert tback.get_spectral(cfg, 2 * L_, torch.device("cpu")) is tsp
    pallas = tback.get_spectral(PipelineConfig(n_channels=2, block_len=L, fft_impl="pallas"),
                                W, "cpu")
    assert pallas._fft is get_fourstep_kernel(W, "cpu")
    fused = tback.get_spectral(PipelineConfig(n_channels=2, block_len=L, fft_impl="fused"),
                               W, "cpu")
    assert fused._k is get_fused_kernels(W, "cpu")
    f32 = tback.get_spectral(PipelineConfig(n_channels=2, block_len=L, fft_impl="mxu",
                                            mxu_precision="f32"), W, "cpu")
    assert f32._fft.precision == "f32"


def test_entry_points_default_to_the_card():
    """Every constructor and entry point that allocates defaults to
    device="cuda"; without a card they raise instead of taking the CPU."""
    from coherent_rtlsdr_tpu_torch.pipeline import state

    for fn in (init_state, state_from_numpy, get_fused_kernels, FusedPipelineKernels,
               FFT4Step, FFT4StepKernel, get_fourstep_kernel, tback.MxuSpectral,
               tback.FusedSpectral, tback.get_spectral):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    for fn in (step, align_offline):
        assert "device" not in inspect.signature(fn).parameters, fn   # the inputs' device
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            state.init_state(PipelineConfig(n_channels=2, block_len=L))
        with pytest.raises((AssertionError, RuntimeError)):
            FFT4StepKernel(W)


def test_fused_runs_with_any_mxu_precision():
    """fft_impl="fused" takes any mxu_precision, as the JAX package does
    (the fused kernels ignore it): the same results as at "bf16"."""
    rng = np.random.default_rng(3)
    sig = torch.from_numpy(rng.integers(0, 256, (3, 2, L, 2), dtype=np.uint8))
    ref = sig[:, 0].clone()
    out = {}
    for prec in ("bf16", "f32"):
        cfg = PipelineConfig(n_channels=2, block_len=L, fft_impl="fused",
                             lag_method="phase_zoom", mxu_precision=prec)
        res = align_offline(cfg, sig, ref)
        _, blk = step(cfg, init_state(cfg, "cpu"), sig[0], ref[0], True)
        out[prec] = (res.wire, blk.wire)
    for a, b in zip(out["bf16"], out["f32"]):
        assert torch.equal(a, b)
