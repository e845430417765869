"""The port's fused i8 path at W = 65536 (m = 256, L = 32768) against the
JAX package, on the same numpy-seeded bytes: the measures and the handoff
apply against ``FusedPipelineKernels`` (Pallas, interpret mode on the CPU),
T = 3 blocks (two windows) of N = 2 channels, and the offline engine
against the JAX engine, 3 channels and 5 blocks. On CPU tensors the port
runs its plain versions, which the CUDA kernels (a window a cluster of four
CTAs at this size) are held to on the card (tests/test_torch_cuda.py).

Bars: the measures by tests/test_torch_fused.py's (scalars where mag >= 0.1,
the same accept/reject decision, the stored spectra D within 1 bf16 ulp but
for under 1e-3 of the elements); the apply on the JAX measure's own D within
1 LSB; the offline engine by tests/test_torch_pipeline.py's (delay 2e-3
samples, lag and phase 1e-3, wire within 2 LSB with under 1e-3 of the bytes
more than 1 LSB apart, the reference wire bit-equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu import pipeline as jpipe
from coherent_rtlsdr_tpu.kernels.pallas_fused import FusedPipelineKernels as JaxKernels
from coherent_rtlsdr_tpu.signal import make_truth as jax_make_truth
from coherent_rtlsdr_tpu.signal import synth_capture as jax_synth_capture
from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels
from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig, align_offline
from coherent_rtlsdr_tpu_torch.tools import cost_model
from test_torch_fused import MIN_CORR_MAG, _assert_measure_close, _stream_bytes
from test_torch_pipeline import FUSED, _assert_wire_close

M = 256
W = M * M
L = W // 2
T, N = 3, 2


@pytest.fixture(scope="module")
def jax_kernels():
    return JaxKernels(W)


@pytest.fixture(scope="module")
def jax_measure(jax_kernels):
    return jax.jit(jax_kernels.measure_i8_spec)


@pytest.mark.parametrize("entry", ["measure_i8_spec", "measure_i8"])
@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_measure_matches_jax_at_w65536(kind, entry, jax_kernels, jax_measure):
    raw, ref_raw = _stream_bytes(kind, seed=65, m=M, t=T, n_ch=N)
    fn = jax_measure if entry == "measure_i8_spec" else jax.jit(jax_kernels.measure_i8)
    j = [np.asarray(x.astype(jnp.float32)) for x in fn(jnp.asarray(raw), jnp.asarray(ref_raw))]
    k = FusedPipelineKernels(W, "cpu")
    t = [x.float().numpy()
         for x in getattr(k, entry)(torch.from_numpy(raw), torch.from_numpy(ref_raw))]
    plain = "measure_spec" if entry == "measure_i8_spec" else "measure_i8"
    assert k.counts() == dict.fromkeys(k.counts(), 0) | {"measure_ref_plain_runs": 1,
                                                         f"{plain}_plain_runs": 1}
    assert len(t) == len(j) == (7 if entry == "measure_i8_spec" else 5)
    assert t[0].shape == (T - 1, N)
    assert all(x.shape == (T - 1, N, M, M) for x in t[5:])
    _assert_measure_close(t, j)
    used = j[3] >= MIN_CORR_MAG
    assert used.all() if kind == "correlated" else not used.any(), j[3]


@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_apply_spec_matches_jax_at_w65536(kind, jax_kernels, jax_measure):
    """The handoff apply on the JAX measure's own D (so the apply is held
    alone), with a large negative and a fractional advance among the
    windows: every wire byte within 1 LSB."""
    raw, ref_raw = _stream_bytes(kind, seed=66, m=M, t=T, n_ch=N)
    rng = np.random.default_rng(67)
    adv = rng.uniform(-40, 40, (T - 1, N)).astype(np.float32)
    adv[0, 0] = -1500.25
    adv[1, 1] = 1023.5
    ph = np.exp(1j * rng.uniform(-np.pi, np.pi, (T - 1, N)))
    args = [adv, ph.real.astype(np.float32), ph.imag.astype(np.float32)]
    jd = jax_measure(jnp.asarray(raw), jnp.asarray(ref_raw))[5:]
    wj = np.asarray(jax.jit(jax_kernels.apply_spec_i8)(*jd, *(jnp.asarray(a) for a in args)))
    d = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in jd]
    k = FusedPipelineKernels(W, "cpu")
    wt = k.apply_spec_i8(*d, *(torch.from_numpy(a) for a in args))
    assert k.counts() == dict.fromkeys(k.counts(), 0) | {"apply_spec_i8_plain_runs": 1}
    assert wt.dtype == torch.int8 and tuple(wt.shape) == (T - 1, N, M // 2, 2 * M)
    assert np.abs(wt.numpy().astype(np.int32) - wj.astype(np.int32)).max() <= 1
    assert np.abs(wj.astype(np.int32)).max() >= 8


@pytest.mark.parametrize("smoothing", ["global", "ema"])
def test_align_offline_matches_jax_at_l32768(smoothing):
    truth = jax_make_truth(3, seed=32, max_delay=30.0, snr_db=30.0)
    cap = jax_synth_capture(jax.random.PRNGKey(32), truth, n_blocks=5, block_len=L)
    sig, ref = np.array(cap.sig_u8), np.array(cap.ref_u8)
    jcfg = jpipe.PipelineConfig(n_channels=3, block_len=L, **FUSED)
    jr = jax.jit(lambda s, r: jpipe.align_offline(jcfg, s, r, smoothing=smoothing))(
        jnp.asarray(sig), jnp.asarray(ref))
    cfg = PipelineConfig(n_channels=3, block_len=L, **FUSED)
    tr = align_offline(cfg, torch.from_numpy(sig), torch.from_numpy(ref), smoothing=smoothing)
    np.testing.assert_allclose(tr.delay.numpy(), np.asarray(jr.delay), atol=2e-3)
    np.testing.assert_allclose(tr.lag.numpy(), np.asarray(jr.lag), atol=1e-3)
    np.testing.assert_allclose(tr.phase.numpy(), np.asarray(jr.phase), atol=1e-3)
    _assert_wire_close(tr.wire.numpy(), np.asarray(jr.wire))
    np.testing.assert_array_equal(tr.wire_ref.numpy(), np.asarray(jr.wire_ref))
    assert tuple(tr.wire.shape) == (4, 3, 2 * L)
    if smoothing == "global":   # the truth delays are recovered at this length
        np.testing.assert_allclose(tr.delay.numpy()[0], truth.delays, atol=0.05)


def test_cost_model_at_m256():
    """The bounds of the four m = 256 kernels at the offline shapes of the
    card's smoke run (N = 21, L = 32768, T = 64: 1,323 channel windows):
    each a forward transform (16 m^3) or the centre-row inverse (12 m^3) a
    window against the bytes each function must move."""
    T64, N21 = 64, 21
    nwin = (T64 - 1) * N21
    spec = cost_model.measure_i8_spec(T64, N21, M)
    assert spec.ops == nwin * 16 * M ** 3
    assert spec.bytes == T64 * N21 * W + (T64 - 1) * (8 * W + 4) + 5 * nwin * 4 + 4 * nwin * W
    assert cost_model.measure_i8(T64, N21, M).bytes == spec.bytes - 4 * nwin * W
    apply = cost_model.apply_spec_i8(T64, N21, M)
    assert apply == cost_model.Cost(4 * nwin * W + 12 * nwin + nwin * W, nwin * 12 * M ** 3)
    assert cost_model.measure_ref(T64, M).ops == (T64 - 1) * 16 * M ** 3
    ms, by = cost_model.bound(spec)
    assert by == "operations" and abs(ms - 0.359) < 0.001
    ms, by = cost_model.bound(apply)
    assert by == "operations" and abs(ms - 0.269) < 0.001
