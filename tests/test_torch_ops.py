"""The PyTorch port's small ops, tables and state against the JAX package,
on the same numpy-made inputs (CPU)."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu import constants as jconst
from coherent_rtlsdr_tpu.kernels import fft4step as jfft
from coherent_rtlsdr_tpu.ops import convert as jconv
from coherent_rtlsdr_tpu.ops import delay as jdelay
from coherent_rtlsdr_tpu.ops import phase as jphase
from coherent_rtlsdr_tpu.pipeline import control as jcontrol
from coherent_rtlsdr_tpu.pipeline import state as jstate
from coherent_rtlsdr_tpu_torch import constants as tconst
from coherent_rtlsdr_tpu_torch.kernels import fft4step as tfft
from coherent_rtlsdr_tpu_torch.ops import convert as tconv
from coherent_rtlsdr_tpu_torch.ops import delay as tdelay
from coherent_rtlsdr_tpu_torch.ops import phase as tphase
from coherent_rtlsdr_tpu_torch.pipeline import control as tcontrol
from coherent_rtlsdr_tpu_torch.pipeline import state as tstate


def _c64(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale).astype(
        np.complex64)


def test_constants_match_jax():
    for name in ("DEFAULT_FS", "DEFAULT_BLOCK_LEN", "SYNC_THRESHOLD", "CTRL_SCALE",
                 "CTRL_FRAC_T", "PHASE_EMA_ALPHA", "IQ_SCALE", "DEFAULT_FCENTER",
                 "FCENTER_MIN_HZ", "FCENTER_MAX_HZ"):
        assert getattr(tconst, name) == getattr(jconst, name), name


@pytest.mark.parametrize("m", [64, 128, 256])
def test_tables_bit_equal(m):
    for tab in ("_dft_matrix", "_twiddle"):
        for a, b in zip(getattr(jfft, tab)(m), getattr(tfft, tab)(m)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_freq_grids_match_jax():
    jf = jfft.FFT4Step(4096)
    tf = tfft.FFT4Step(4096, "cpu")
    np.testing.assert_array_equal(np.asarray(jf.freq_index_grid()), tf.freq_index_grid().numpy())
    np.testing.assert_array_equal(np.asarray(jf.signed_freq_grid()), tf.signed_freq_grid().numpy())
    for n in (4096, 16384, 65536, 1024, 4000):
        assert tfft.supported_fft_len(n) == jfft.supported_fft_len(n)


def test_convert_matches_jax():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (3, 64, 2), dtype=np.uint8)
    i8 = tconv.u8_to_i8(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(i8, np.asarray(jconv.u8_to_i8(jnp.asarray(u8))))
    np.testing.assert_array_equal(tconv.i8_iq_to_c64(torch.from_numpy(i8)).numpy(),
                                  np.asarray(jconv.i8_iq_to_c64(jnp.asarray(i8))))
    # Values on the .5 rounding boundaries and past saturation included.
    x = _c64(rng, (3, 64), 0.5)
    x[0, :4] = np.array([0.5, 1.5, -2.5, 3.0]) / 127.0 + 2j
    np.testing.assert_array_equal(tconv.c64_to_i8_iq(torch.from_numpy(x)).numpy(),
                                  np.asarray(jconv.c64_to_i8_iq(jnp.asarray(x))))
    f = tconv.c2f(torch.from_numpy(x))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jconv.c2f(jnp.asarray(x))))
    np.testing.assert_array_equal(tconv.f2c(f).numpy(), x)


def test_phase_matches_jax():
    rng = np.random.default_rng(1)
    sig, ref = _c64(rng, (4, 256)), _c64(rng, (256,))
    prev, new = _c64(rng, (4,)), _c64(rng, (4,))
    prev[0] = 0.0
    new[0] = 0.0   # the zero-magnitude branch: factor 1
    # The estimate normalizes a 256-term float32 sum that the two libraries
    # add in different orders: ~sqrt(256) * 2^-24 = 1e-6 relative apart.
    np.testing.assert_allclose(
        tphase.phase_correction_estimate(torch.from_numpy(sig), torch.from_numpy(ref)).numpy(),
        np.asarray(jphase.phase_correction_estimate(jnp.asarray(sig), jnp.asarray(ref))),
        atol=3e-6)
    for renorm in (True, False):
        np.testing.assert_allclose(
            tphase.ema_complex(torch.from_numpy(prev), torch.from_numpy(new), 0.5,
                               renorm).numpy(),
            np.asarray(jphase.ema_complex(jnp.asarray(prev), jnp.asarray(new), 0.5, renorm)),
            atol=1e-6)


def test_delay_ramp_matches_jax():
    d = np.array([0.0, 0.25, -3.75, 40.5, -2047.125, 1500.0], np.float32)
    for W in (4096, 65536):
        np.testing.assert_allclose(
            tdelay.delay_ramp(W, torch.from_numpy(d)).numpy(),
            np.asarray(jdelay.delay_ramp(W, jnp.asarray(d))), atol=1e-6)
    with pytest.raises(ValueError):
        tdelay.delay_ramp(4000, torch.zeros(1))


def test_control_update_matches_jax():
    rng = np.random.default_rng(2)
    N = 64
    delay = rng.uniform(-50, 50, N).astype(np.float32)
    lag = (delay + rng.uniform(-300, 300, N)).astype(np.float32)
    lag[:8] = delay[:8] + np.float32(0.004)   # inside the sync threshold
    mag = rng.uniform(0, 0.3, N).astype(np.float32)
    synced = rng.integers(0, 2, N).astype(bool)
    gate = rng.integers(0, 2, N).astype(bool)
    for L in (2048, 8192):
        jcfg = jstate.PipelineConfig(n_channels=N, block_len=L)
        tcfg = tstate.PipelineConfig(n_channels=N, block_len=L)
        assert dataclass_dict(tcfg) == dataclass_dict(jcfg)
        jd, js = jcontrol.control_update(jcfg, jnp.asarray(delay), jnp.asarray(synced),
                                         jnp.asarray(lag), jnp.asarray(mag), jnp.asarray(gate))
        td, ts = tcontrol.control_update(tcfg, torch.from_numpy(delay), torch.from_numpy(synced),
                                         torch.from_numpy(lag), torch.from_numpy(mag),
                                         torch.from_numpy(gate))
        # tanh may differ by an ulp between the two libraries.
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def dataclass_dict(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


def _jax_state(rng, N=3, L=2048):
    """A mid-stream JAX fused-layout state with random leaves, seqnums
    at and above 2^31 included."""
    m = int(round((2 * L) ** 0.5))
    phase = _c64(rng, (N,))
    phase /= np.abs(phase)
    return jstate.PipelineState(
        delay=jnp.asarray(rng.uniform(-9, 9, N).astype(np.float32)),
        phase=jnp.asarray(np.stack([phase.real, phase.imag], -1).astype(np.float32)),
        lag=jnp.asarray(rng.uniform(-9, 9, N).astype(np.float32)),
        mag=jnp.asarray(rng.uniform(0, 1, N).astype(np.float32)),
        papr=jnp.asarray(rng.uniform(0, 900, N).astype(np.float32)),
        synced=jnp.asarray(np.array([True, False, True])[:N]),
        hist=jnp.asarray(rng.integers(-128, 128, (N, m // 2, 2 * m), dtype=np.int8)),
        ref_hist=jnp.asarray(rng.integers(-128, 128, (m // 2, 2 * m), dtype=np.int8)),
        block_idx=jnp.asarray(np.int32(17)),
        last_seq=jnp.asarray(np.array([2**31, 2**32 - 1, 5], np.uint32)[:N]),
        gaps=jnp.asarray(np.array([0, 4, 1], np.int32)[:N]),
    )


def _leaves(s):
    return {k: np.asarray(getattr(s, k)) for k in tstate._NUMPY_DTYPES}


def test_state_numpy_round_trip_is_exact():
    js = _jax_state(np.random.default_rng(3))
    ts = tstate.state_from_numpy(js, "cpu")
    assert ts.last_seq.dtype == torch.int64 and int(ts.last_seq[1]) == 2**32 - 1
    back = tstate.state_to_numpy(ts)
    for name, a in _leaves(js).items():
        assert back[name].dtype == a.dtype, name
        np.testing.assert_array_equal(back[name], a, err_msg=name)


def test_pack_state_matches_jax_and_round_trips():
    js = _jax_state(np.random.default_rng(4))
    ts = tstate.state_from_numpy(js, "cpu")
    tpacked = tstate.pack_state(ts)
    for a, b in zip(jstate.pack_state(js), tpacked):
        assert str(b.dtype).split(".")[-1] == str(np.asarray(a).dtype), (a.dtype, b.dtype)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    again = tstate.state_to_numpy(tstate.unpack_state(*tpacked))
    for name, a in _leaves(js).items():
        np.testing.assert_array_equal(again[name], a, err_msg=name)


def test_pack_telemetry_matches_jax():
    rng = np.random.default_rng(5)
    N = 4
    f = lambda: rng.standard_normal(N).astype(np.float32)
    b = lambda: rng.integers(0, 2, N).astype(bool)
    leaves = dict(lag=f(), residual=f(), mag=f(), papr=f(), rms=f(),
                  phase=rng.standard_normal((N, 2)).astype(np.float32), synced=b(),
                  gap=b(), gaps=rng.integers(0, 9, N).astype(np.int32))
    jt = jstate.Telemetry(**{k: jnp.asarray(v) for k, v in leaves.items()})
    tt = tstate.Telemetry(**{k: torch.from_numpy(v) for k, v in leaves.items()})
    assert tstate.TELEMETRY_COLS == jstate.TELEMETRY_COLS
    assert (tstate.PPACK_COLS, tstate.IPACK_COLS) == (jstate.PPACK_COLS, jstate.IPACK_COLS)
    np.testing.assert_array_equal(tstate.pack_telemetry(tt).numpy(),
                                  np.asarray(jstate.pack_telemetry(jt)))


def test_init_state_matches_jax_layout():
    for L in (2048, 8192):
        jcfg = jstate.PipelineConfig(n_channels=3, block_len=L, fft_impl="fused")
        tcfg = tstate.PipelineConfig(n_channels=3, block_len=L, fft_impl="fused")
        back = tstate.state_to_numpy(tstate.init_state(tcfg, "cpu"))
        for name, a in _leaves(jstate.init_state(jcfg)).items():
            assert back[name].dtype == a.dtype and back[name].shape == a.shape, name
            np.testing.assert_array_equal(back[name], a, err_msg=name)


def test_import_loads_no_jax():
    code = ("import sys, coherent_rtlsdr_tpu_torch.pipeline, coherent_rtlsdr_tpu_torch.signal, "
            "coherent_rtlsdr_tpu_torch.kernels.fused_cuda, coherent_rtlsdr_tpu_torch.io.server, "
            "coherent_rtlsdr_tpu_torch.signal.sources, coherent_rtlsdr_tpu_torch.native, "
            "coherent_rtlsdr_tpu_torch.io.hwcontrol, coherent_rtlsdr_tpu_torch.io.client, "
            "coherent_rtlsdr_tpu_torch.apps.coherent_server, "
            "coherent_rtlsdr_tpu_torch.apps.align_offline, "
            "coherent_rtlsdr_tpu_torch.apps.capture_daemon, "
            "coherent_rtlsdr_tpu_torch.models, coherent_rtlsdr_tpu_torch.models.localize, "
            "coherent_rtlsdr_tpu_torch.apps.music_client; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'coherent_rtlsdr_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
