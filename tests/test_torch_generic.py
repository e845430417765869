"""The port's generic pipeline (fft_impl "xla", "mxu" at f32 and bf16,
"pallas") against the JAX package's: the streaming step block by block, the
drivers, the offline engine and the generic state layout, on the same
synthetic bytes (CPU; the port runs its plain versions, the JAX package its
Pallas four-step in interpret mode).

Bars: delay and lag atol 2e-3 samples (the control law and the smoother
integrate the lag estimators' differences, tests/test_torch_spectral.py);
phase factors atol 1e-3; aligned samples after ``c64_to_i8_iq`` within the
wire bars, max |diff| <= 2 LSB with under 1e-3 of them > 1 LSB
(tests/test_kernels.py:443-450); the reference channel, sync flags, gap
counts and seqnums exactly. Truth recovery: delay within 0.1 samples and
phase within 3 degrees (tests/test_kernels.py:108-123, 177-188).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu import pipeline as jpipe
from coherent_rtlsdr_tpu.pipeline import state as jstate_mod
from coherent_rtlsdr_tpu.signal import make_truth as jax_make_truth
from coherent_rtlsdr_tpu.signal import synth_capture as jax_synth_capture
from coherent_rtlsdr_tpu_torch.ops.convert import c64_to_i8_iq
from coherent_rtlsdr_tpu_torch.pipeline import (
    PipelineConfig,
    align_offline,
    init_state,
    make_packed_scan_runner,
    make_packed_step,
    make_scan_runner,
    run_capture,
    step,
)
from coherent_rtlsdr_tpu_torch.pipeline.state import (
    pack_state,
    state_from_numpy,
    state_to_numpy,
    unpack_state,
)
from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_capture

L = 2048
N, T = 3, 8
IMPLS = {
    "xla": dict(fft_impl="xla"),
    "mxu-f32": dict(fft_impl="mxu", mxu_precision="f32"),
    "mxu-bf16": dict(fft_impl="mxu", mxu_precision="bf16"),
    "pallas": dict(fft_impl="pallas"),
}


def _assert_wire_close(a, b):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert d.max() <= 2, d.max()
    assert (d > 1).mean() < 1e-3, (d > 1).mean()


def _wire(x):
    return c64_to_i8_iq(torch.from_numpy(np.array(x))).numpy()


@pytest.fixture(scope="module")
def stream():
    """The JAX synthesizer's bytes ([T, N, L, 2] / [T, L, 2] u8)."""
    truth = jax_make_truth(N, seed=7, max_delay=25.0, snr_db=30.0)
    cap = jax_synth_capture(jax.random.PRNGKey(7), truth, n_blocks=T, block_len=L)
    return np.array(cap.sig_u8), np.array(cap.ref_u8)


def _seqs(start=0):
    s = (start + 1 + np.arange(T, dtype=np.int64))[:, None] % 2**32
    return np.broadcast_to(s, (T, N)).astype(np.uint32)


@pytest.mark.parametrize("name", list(IMPLS))
def test_generic_step_matches_jax(name, stream):
    sig, ref = stream
    jcfg = jpipe.PipelineConfig(n_channels=N, block_len=L, **IMPLS[name])
    cfg = PipelineConfig(n_channels=N, block_len=L, **IMPLS[name])
    gate = jnp.array(True)
    jstep = jax.jit(lambda s, a, b, q: jpipe.step(jcfg, s, a, b, gate, seq=q))
    seqs = _seqs(start=2**32 - 3)
    jstate, tstate = jpipe.init_state(jcfg), init_state(cfg, "cpu")
    for t in range(T):
        jstate, jout = jstep(jstate, jnp.asarray(sig[t]), jnp.asarray(ref[t]),
                             jnp.asarray(seqs[t]))
        tstate, tout = step(cfg, tstate, torch.from_numpy(sig[t]), torch.from_numpy(ref[t]),
                            True, seq=seqs[t])
        assert tout.wire is None and tout.aligned.dtype == torch.complex64
        np.testing.assert_allclose(tstate.delay.numpy(), np.asarray(jstate.delay), atol=2e-3)
        np.testing.assert_allclose(tout.telemetry.lag.numpy(), np.asarray(jout.telemetry.lag),
                                   atol=2e-3)
        np.testing.assert_allclose(tout.telemetry.rms.numpy(), np.asarray(jout.telemetry.rms),
                                   rtol=1e-5)
        _assert_wire_close(c64_to_i8_iq(tout.aligned).numpy(), _wire(jout.aligned))
        np.testing.assert_array_equal(tout.ref.numpy(), np.asarray(jout.ref))
        np.testing.assert_array_equal(tstate.synced.numpy(), np.asarray(jstate.synced))
        np.testing.assert_array_equal(tstate.gaps.numpy(), np.asarray(jstate.gaps))
        np.testing.assert_array_equal(tstate.last_seq.numpy(),
                                      np.asarray(jstate.last_seq).astype(np.int64))
    np.testing.assert_allclose(tstate.phase.numpy(), np.asarray(jstate.phase), atol=1e-3)
    assert tstate.synced.all()


def test_generic_drivers_equal_the_step_loop(stream):
    sig, ref = (torch.from_numpy(x) for x in stream)
    cfg = PipelineConfig(n_channels=N, block_len=L, fft_impl="pallas")
    seqs = _seqs(start=2**32 - 3)
    state = init_state(cfg, "cpu")
    wires, refs, telems = [], [], []
    for t in range(T):
        state, out = step(cfg, state, sig[t], ref[t], True, seq=seqs[t])
        wires.append(c64_to_i8_iq(out.aligned))
        refs.append(c64_to_i8_iq(out.ref))
        telems.append(out.telemetry)

    run = make_packed_scan_runner(cfg)
    pstate = pack_state(init_state(cfg, "cpu"))
    assert tuple(pstate[2].shape) == (N + 1, L, 2) and pstate[2].dtype == torch.float32
    got_w, got_r = [], []
    flat = lambda x: x.reshape(*x.shape[:-2], 2 * L)   # the packed runner takes flat bytes
    for c in range(2):
        blk = slice(4 * c, 4 * c + 4)
        pstate, (w, wr), tel = run(pstate, flat(sig[blk]), flat(ref[blk]), True, seqs[blk])
        assert tuple(w.shape) == (4, N, L, 2) and tuple(wr.shape) == (4, L, 2)
        assert tuple(tel.shape) == (4, N, 10)
        got_w.append(w)
        got_r.append(wr)
    assert torch.equal(torch.cat(got_w), torch.stack(wires))
    assert torch.equal(torch.cat(got_r), torch.stack(refs))
    for a, b in zip(pack_state(state), pstate):
        assert torch.equal(a, b)

    p1, w1, wr1, tel1 = make_packed_step(cfg)(pack_state(init_state(cfg, "cpu")), sig[0],
                                              ref[0], True, seqs[0])
    assert torch.equal(w1, wires[0]) and tuple(tel1.shape) == (N, 10)

    s2, w2, wr2, tel2 = run_capture(cfg, init_state(cfg, "cpu"), sig, ref)
    assert torch.equal(w2, torch.stack(wires)) and tuple(tel2.lag.shape) == (T, N)
    assert torch.equal(tel2.lag, torch.stack([t.lag for t in telems]))
    s3, (a3, r3), tel3 = make_scan_runner(cfg, emit_wire=False, pack_telem=True)(
        init_state(cfg, "cpu"), sig[:4], ref[:4], True)
    assert a3.dtype == torch.float32 and tuple(a3.shape) == (4, N, L, 2)
    assert tuple(tel3.shape) == (4, N, 10)
    assert torch.equal(c64_to_i8_iq(torch.complex(a3[..., 0], a3[..., 1])), torch.stack(wires[:4]))


@pytest.mark.parametrize("smoothing", ["global", "ema"])
@pytest.mark.parametrize("name", ["xla", "pallas"])
def test_generic_align_offline_matches_jax(name, smoothing):
    truth = jax_make_truth(4, seed=4, max_delay=30.0, snr_db=30.0)
    cap = jax_synth_capture(jax.random.PRNGKey(4), truth, n_blocks=T, block_len=L)
    sig, ref = np.array(cap.sig_u8), np.array(cap.ref_u8)
    jcfg = jpipe.PipelineConfig(n_channels=4, block_len=L, **IMPLS[name])
    jr = jax.jit(lambda s, r: jpipe.align_offline(jcfg, s, r, smoothing=smoothing))(
        jnp.asarray(sig), jnp.asarray(ref))
    cfg = PipelineConfig(n_channels=4, block_len=L, **IMPLS[name])
    tr = align_offline(cfg, torch.from_numpy(sig), torch.from_numpy(ref), smoothing=smoothing)
    np.testing.assert_allclose(tr.delay.numpy(), np.asarray(jr.delay), atol=2e-3)
    np.testing.assert_allclose(tr.lag.numpy(), np.asarray(jr.lag), atol=2e-3)
    np.testing.assert_allclose(tr.mag.numpy(), np.asarray(jr.mag), rtol=1e-3)
    np.testing.assert_allclose(tr.phase.numpy(), np.asarray(jr.phase), atol=1e-3)
    assert tr.wire is None and tuple(tr.aligned.shape) == (T - 1, 4, L)
    _assert_wire_close(c64_to_i8_iq(tr.aligned).numpy(), _wire(jr.aligned))
    np.testing.assert_array_equal(tr.ref.numpy(), np.asarray(jr.ref))


def test_pallas_recovers_truth():
    """fft_impl="pallas" end to end on the port's synthesizer: the
    streaming step locks every channel, and the offline engine aligns delay
    and phase."""
    truth = make_truth(N, seed=2, max_delay=30.0, snr_db=30.0)
    cap = synth_capture(torch.Generator().manual_seed(2), truth, n_blocks=T, block_len=L)
    cfg = PipelineConfig(n_channels=N, block_len=L, fft_impl="pallas")
    state = init_state(cfg, "cpu")
    for t in range(T):
        state, out = step(cfg, state, cap.sig_u8[t], cap.ref_u8[t], True)
    np.testing.assert_allclose(state.delay.numpy(), truth.delays, atol=0.1)
    assert bool(state.synced.all())
    res = align_offline(cfg, cap.sig_u8, cap.ref_u8)
    np.testing.assert_allclose(res.delay.numpy()[0], truth.delays, atol=0.1)
    z = (res.aligned * res.ref[:, None].conj()).sum(-1)
    assert np.degrees(np.abs(np.angle(z.numpy()))).max() < 3.0


def test_generic_state_matches_jax_layout():
    for impl in ("xla", "pallas"):
        jcfg = jstate_mod.PipelineConfig(n_channels=N, block_len=L, fft_impl=impl)
        cfg = PipelineConfig(n_channels=N, block_len=L, fft_impl=impl)
        back = state_to_numpy(init_state(cfg, "cpu"))
        for name, a in state_to_numpy(state_from_numpy(jpipe.init_state(jcfg), "cpu")).items():
            assert back[name].dtype == a.dtype and back[name].shape == a.shape, name
            np.testing.assert_array_equal(back[name], a, err_msg=name)
    rng = np.random.default_rng(9)
    js = jpipe.init_state(jcfg).replace(
        hist=jnp.asarray(rng.standard_normal((N, L, 2)).astype(np.float32)),
        ref_hist=jnp.asarray(rng.standard_normal((L, 2)).astype(np.float32)),
        last_seq=jnp.asarray(np.array([2**31, 2**32 - 1, 5], np.uint32)),
        block_idx=jnp.asarray(np.int32(9)))
    ts = state_from_numpy(js, "cpu")
    assert ts.hist.dtype == torch.float32
    for a, b in zip(jstate_mod.pack_state(js), pack_state(ts)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    again = state_to_numpy(unpack_state(*pack_state(ts)))
    for name in ("hist", "ref_hist", "last_seq", "block_idx"):
        np.testing.assert_array_equal(again[name], np.asarray(getattr(js, name)), err_msg=name)
