"""The port's recompute i8 pair (``measure_i8``, ``apply_i8``), the block
copy and the roofline probe's cost model and functions, against the JAX
package's ``FusedPipelineKernels`` (Pallas, interpret mode on the CPU) on the
same bytes. On CPU tensors the port runs its plain versions; the CUDA
kernels are held to those on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Bars, and why (those of tests/test_torch_fused.py):
  * measure scalars where the pipeline uses the measurement (mag >= 0.1):
    lag atol 1e-3 samples; z, mag, papr rtol 1e-3 (another arctangent and
    other float32 summation orders); the same accept/reject decision;
  * wire bytes: max |diff| <= 2 LSB and under 1e-3 of them > 1 LSB;
  * the handoff contract inside the port, the JAX package's own
    (tests/test_kernels.py:433-450): scalars equal within 1e-6, wire bytes
    within those bars and under 35 % of them different at all.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.kernels.pallas_fused import FusedPipelineKernels as JaxKernels
from coherent_rtlsdr_tpu_torch.kernels import fused_cuda
from coherent_rtlsdr_tpu_torch.kernels.copy import BlockCopy, get_block_copy
from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels
from coherent_rtlsdr_tpu_torch.tools import cost_model, probe_roofline
from test_torch_fused import M, MIN_CORR_MAG, N, T, W, _stream_bytes


def _assert_scalars_close(got, want):
    for x in got:
        assert np.isfinite(x).all()
    used = want[3] >= MIN_CORR_MAG
    np.testing.assert_array_equal(got[3] >= MIN_CORR_MAG, used)
    np.testing.assert_allclose(got[0][used], want[0][used], atol=1e-3)
    for name, a, b in zip(("z_re", "z_im", "mag", "papr"), got[1:], want[1:]):
        np.testing.assert_allclose(a[used], b[used], rtol=1e-3, err_msg=name)


def _wire_diff(a, b):
    return np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))


def _assert_wire_close(a, b):
    d = _wire_diff(a, b)
    assert d.max() <= 2, d.max()
    assert (d > 1).mean() < 1e-3, (d > 1).mean()


def _apply_args(seed):
    """Advances with a large integer part of either sign, and unit phase
    factors, float32 [T-1, N]."""
    rng = np.random.default_rng(seed)
    adv = rng.uniform(-40, 40, (T - 1, N)).astype(np.float32)
    adv[0, 0] = -1500.25
    adv[0, 1] = 1023.5
    ph = np.exp(1j * rng.uniform(-np.pi, np.pi, (T - 1, N)))
    return adv, ph.real.astype(np.float32), ph.imag.astype(np.float32)


@pytest.fixture(scope="module")
def jax_kernels():
    return JaxKernels(W)


@pytest.fixture(scope="module")
def jax_measure_i8(jax_kernels):
    return jax.jit(jax_kernels.measure_i8)


@pytest.fixture(scope="module")
def jax_apply_i8(jax_kernels):
    return jax.jit(jax_kernels.apply_i8)


@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_measure_i8_matches_jax(kind, jax_measure_i8):
    raw, ref_raw = _stream_bytes(kind, seed=21)
    j = [np.asarray(x) for x in jax_measure_i8(jnp.asarray(raw), jnp.asarray(ref_raw))]
    k = FusedPipelineKernels(W, "cpu")
    R, eref = k.measure_ref_plain(torch.from_numpy(ref_raw))
    t = [x.numpy() for x in k.measure_i8_plain(torch.from_numpy(raw), R, eref)]
    assert k.counts() == dict.fromkeys(k.counts(), 0) | dict(measure_ref_plain_runs=1,
                                                            measure_i8_plain_runs=1)
    assert len(t) == 5 and all(x.shape == (T - 1, N) and x.dtype == np.float32 for x in t)
    _assert_scalars_close(t, j)
    used = j[3] >= MIN_CORR_MAG
    assert used.all() if kind == "correlated" else not used.any(), j[3]


@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_apply_i8_matches_jax(kind, jax_apply_i8):
    raw, _ = _stream_bytes(kind, seed=22)
    args = _apply_args(23)
    wj = np.asarray(jax_apply_i8(jnp.asarray(raw), *(jnp.asarray(a) for a in args)))
    k = FusedPipelineKernels(W, "cpu")
    wt = k.apply_i8_plain(torch.from_numpy(raw), *(torch.from_numpy(a) for a in args))
    assert k.counts() == dict.fromkeys(k.counts(), 0) | dict(apply_i8_plain_runs=1)
    assert wt.dtype == torch.int8 and tuple(wt.shape) == (T - 1, N, M // 2, 2 * M)
    _assert_wire_close(wt.numpy(), wj)


@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_handoff_contract_in_the_port(kind):
    """measure_i8 gives the scalars of measure_i8_spec, and apply_i8 the
    wire bytes of apply_spec_i8 up to the bf16 rounding of the stored D."""
    raw, ref_raw = (torch.from_numpy(x) for x in _stream_bytes(kind, seed=24))
    adv, pre, pim = (torch.from_numpy(a) for a in _apply_args(25))
    k = FusedPipelineKernels(W, "cpu")
    base = k.measure_i8(raw, ref_raw)
    spec = k.measure_i8_spec(raw, ref_raw)
    for a, b in zip(base, spec[:5]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    d = _wire_diff(k.apply_i8(raw, adv, pre, pim), k.apply_spec_i8(*spec[5:], adv, pre, pim))
    assert d.max() <= 2 and (d > 1).mean() < 1e-3 and (d != 0).mean() < 0.35
    assert k.counts() == dict.fromkeys(k.counts(), 0) | dict(
        measure_ref_plain_runs=2, measure_i8_plain_runs=1, measure_spec_plain_runs=1,
        apply_i8_plain_runs=1, apply_spec_i8_plain_runs=1)


def test_recompute_chain_matches_jax(jax_measure_i8, jax_apply_i8):
    """Bytes -> measure_i8 -> advance = lag, phase factor = conj(z)/|z| ->
    apply_i8 -> wire bytes, in the port and in the JAX package."""
    raw, ref_raw = _stream_bytes("correlated", seed=26)
    lag, zre, zim, _, _ = jax_measure_i8(jnp.asarray(raw), jnp.asarray(ref_raw))
    zabs = jnp.sqrt(zre * zre + zim * zim)
    wj = np.asarray(jax_apply_i8(jnp.asarray(raw), lag, zre / zabs, -zim / zabs))
    k = FusedPipelineKernels(W, "cpu")
    traw = torch.from_numpy(raw)
    lag_t, zre_t, zim_t, mag_t, _ = k.measure_i8(traw, torch.from_numpy(ref_raw))
    assert (mag_t >= MIN_CORR_MAG).all()
    np.testing.assert_allclose(lag_t.numpy(), np.asarray(lag), atol=1e-3)
    zabs_t = torch.sqrt(zre_t * zre_t + zim_t * zim_t)
    wt = k.apply_i8(traw, lag_t, zre_t / zabs_t, -zim_t / zabs_t)
    _assert_wire_close(wt.numpy(), wj)
    # The chain aligns: every channel's wire block correlates with the
    # reference in phase.
    y = wt.numpy().astype(np.float32).reshape(T - 1, N, -1, 2)
    r = ref_raw.astype(np.float32).reshape(T, -1, 2)
    L = W // 2
    ref_c = np.concatenate([r[:-1], r[1:]], axis=1)[:, L // 2: 3 * L // 2]
    zc = (((y[..., 0] + 1j * y[..., 1]) * np.conj(ref_c[:, None, :, 0]
                                                    + 1j * ref_c[:, None, :, 1])).sum(-1))
    assert np.abs(np.angle(zc)).max() < np.deg2rad(5.0)


@pytest.mark.parametrize("nc", [1, 3])
def test_block_copy_on_cpu_is_bit_equal(nc):
    x = torch.from_numpy(_stream_bytes("random", seed=27)[0])
    c = BlockCopy()
    y = c.copy(x, nc)
    assert y.data_ptr() != x.data_ptr() and torch.equal(y, x) and y.dtype == torch.int8
    assert c.counts() == dict(copy_launches=0, copy_plain_runs=1)
    assert get_block_copy() is get_block_copy()


@pytest.mark.parametrize("name, shape, want", [
    ("copy_blocks", (256, 21, 128), (176_160_768, 0)),
    ("measure_i8", (256, 21, 128), (256 * 21 * 16384 + 255 * (16384 * 8 + 4) + 5 * 5355 * 4,
                                    179_683_983_360)),
    ("measure_i8_spec", (256, 21, 128), (256 * 21 * 16384 + 255 * (16384 * 8 + 4)
                                         + 5 * 5355 * 4 + 4 * 5355 * 16384, 179_683_983_360)),
    ("apply_i8", (256, 21, 128), (256 * 21 * 16384 + 3 * 5355 * 4 + 5355 * 16384,
                                  314_446_970_880)),
    ("apply_spec_i8", (256, 21, 128), (4 * 5355 * 16384 + 3 * 5355 * 4 + 5355 * 16384,
                                       134_762_987_520)),
    ("measure_ref", (256, 128), (256 * 16384 + 255 * (16384 * 8 + 4), 8_556_380_160)),
    ("fourstep", (5355, 128), (2 * 5355 * 16384 * 8, 179_683_983_360)),
])
def test_cost_model_known_values(name, shape, want):
    """At N = 21, L = 8192 (m = 128), T = 256: 5,355 windows; a forward
    transform is 16 m^3 = 33,554,432 operations, the centre-row inverse
    12 m^3."""
    assert tuple(getattr(cost_model, name)(*shape)) == want


def test_cost_model_bounds_and_per_sample():
    ms, by = cost_model.bound(cost_model.copy_blocks(256, 21, 128))
    assert by == "bytes" and abs(ms - 0.0525853) < 1e-6
    ms, by = cost_model.bound(cost_model.measure_i8(256, 21, 128))
    assert by == "operations" and abs(ms - 0.1816825) < 1e-6
    ms, by = cost_model.bound(cost_model.apply_i8(256, 21, 128))
    assert by == "operations" and abs(ms - 0.3179444) < 1e-6
    samples = 255 * 21 * 8192
    for pair in ("handoff", "recompute"):
        c = cost_model.pair_cost(pair, 256, 21, 128)
        assert cost_model.fused_cost_model(21, 8192, 256, pair) == (c.bytes / samples,
                                                                    c.ops / samples)
    hb, hf = cost_model.fused_cost_model(21, 8192)
    rb, rf = cost_model.fused_cost_model(21, 8192, pair="recompute")
    # The handoff moves D out and back (8 bytes a sample) and skips the
    # second forward transform (16 m^3 a window, 16 m^3 / L a sample).
    assert hb > rb + 7 and abs((rf - hf) - 16 * 128 ** 3 / 8192) < 1e-6
    with pytest.raises(ValueError):
        cost_model.fused_cost_model(21, 8000)
    with pytest.raises(ValueError):
        cost_model.pair_cost("other", 256, 21, 128)


def test_probe_runs_on_cpu():
    out = probe_roofline.run(device="cpu", n_ch=3, block_len=2048, fused_ts=(3,), matmul_n=64)
    assert out["device"] == "cpu" and out["card"] is None
    for key in ("copy_GBps", "torch_copy_GBps", "xor_GBps"):
        assert list(out[key]) == [64, 256] and min(out[key].values()) > 0
    # nc = 3 at N = 3, as the JAX kernels batch 7 of 21 channels a step.
    assert out["copy_nc3_GBps"] > 0 and out["matmul_TFLOPs"] > 0
    assert [probe_roofline.channels_per_cta(n) for n in (21, 3, 16, 11)] == [7, 3, 8, 1]
    (f,) = out["fused"]
    assert f["T"] == 3 and f["recompute_over_handoff"] > 0
    for pair in ("handoff", "recompute"):
        assert set(f[pair]) == {"ms", "us_per_window", "samples_per_s", "modeled_GBps",
                                "modeled_TFLOPs"}
        assert set(out["fractions"][pair]) == {"T", "of_probed_copy", "of_probed_matmul",
                                               "of_datasheet_bytes", "of_datasheet_bf16"}
    # Each timed function runs once to warm up and RUNS times: three copies
    # (T = 64 and 256 at nc = 1, T = 256 at nc = 3) and both pairs, all
    # through the plain versions.
    n = 1 + probe_roofline.RUNS
    assert out["launches"] == dict(
        copy_plain_runs=3 * n, measure_ref_plain_runs=2 * n, measure_spec_plain_runs=n,
        apply_spec_i8_plain_runs=n, measure_i8_plain_runs=n, apply_i8_plain_runs=n)
    assert json.loads(json.dumps(out))["fused"][0]["T"] == 3


def test_probe_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="found none"):
        probe_roofline.run()
    with pytest.raises(RuntimeError, match="found none"):
        probe_roofline.probe_copy(3)


def test_cuda_wrappers_reject_m256():
    """Both recompute wrappers take m in {64, 128, 256} (at m = 256 their
    cluster kernels) and refuse a size with no kernel (m = 32 and 512)
    before touching a device; a CPU tensor at m = 256 gets past the size
    check to the device check. The copy refuses what it cannot take."""
    for m in (64, 128, 256):
        fused_cuda.admit("fused_measure_i8", m)
        fused_cuda.admit("fused_apply_i8", m)
    k = FusedPipelineKernels(65536, "cpu")
    raw = torch.zeros((2, 1, 128, 512), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="kernels built for cpu"):
        fused_cuda.apply_i8(k, raw, *(torch.zeros((1, 1)),) * 3)
    for m in (32, 512):
        km = FusedPipelineKernels(m * m, "cpu")
        raw_m = torch.zeros((2, 1, m // 2, 2 * m), dtype=torch.int8)
        with pytest.raises(ValueError, match="m in"):
            fused_cuda.measure_i8(km, raw_m, *km.measure_ref_plain(raw_m[:, 0]))
        with pytest.raises(ValueError, match="m in"):
            fused_cuda.apply_i8(km, raw_m, *(torch.zeros((1, 1)),) * 3)
    with pytest.raises(ValueError, match="N a multiple of nc"):
        fused_cuda.copy_blocks(BlockCopy(), torch.zeros((2, 3, 32, 128), dtype=torch.int8), 2)
    with pytest.raises(ValueError, match="int8"):
        fused_cuda.copy_blocks(BlockCopy(), torch.zeros((2, 3, 32, 128)), 1)


def test_no_fallback_on_other_devices():
    k = FusedPipelineKernels(W, "cpu")
    meta = torch.empty((T, N, M // 2, 2 * M), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        k.measure_i8(meta, meta[:, 0])
    with pytest.raises(ValueError, match="meta"):
        k.apply_i8(meta, *(torch.empty((T - 1, N), device="meta"),) * 3)
    assert set(k.counts().values()) == {0}
    c = BlockCopy()
    with pytest.raises(ValueError, match="meta"):
        c.copy(meta)
    assert set(c.counts().values()) == {0}
