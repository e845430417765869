"""The port's streaming step, drivers and offline engine (fused i8 path)
against the JAX package's, on the same synthetic bytes (CPU; the port runs
its plain kernel versions here).

Bars: delay atol 2e-3 samples (the control law and the smoother integrate
the measurement differences of tests/test_torch_fused.py); wire bytes max
|diff| <= 2 LSB with under 1e-3 of them > 1 LSB (tests/test_kernels.py:
443-450); the reference channel's wire bytes, sync flags and gap counts
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu import pipeline as jpipe
from coherent_rtlsdr_tpu.signal import make_truth as jax_make_truth
from coherent_rtlsdr_tpu.signal import synth_capture as jax_synth_capture
from coherent_rtlsdr_tpu_torch.pipeline import (
    PipelineConfig,
    align_offline,
    init_state,
    make_packed_scan_runner,
    make_packed_step,
    run_capture,
    step,
)
from coherent_rtlsdr_tpu_torch.pipeline.state import pack_state, state_from_numpy
from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_capture

L = 2048
FUSED = dict(fft_impl="fused", lag_method="phase_zoom")


def _assert_wire_close(a, b):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert d.max() <= 2, d.max()
    assert (d > 1).mean() < 1e-3, (d > 1).mean()


@pytest.fixture(scope="module")
def stream():
    """The JAX synthesizer's bytes (flat [T, N, 2L] / [T, 2L] u8): 3
    channels, 10 blocks."""
    truth = jax_make_truth(3, seed=7, max_delay=25.0, snr_db=30.0)
    cap = jax_synth_capture(jax.random.PRNGKey(7), truth, n_blocks=10, block_len=L)
    return (np.array(cap.sig_u8).reshape(10, 3, 2 * L),
            np.array(cap.ref_u8).reshape(10, 2 * L))


@pytest.fixture(scope="module")
def jax_step():
    cfg = jpipe.PipelineConfig(n_channels=3, block_len=L, **FUSED)
    gate = jnp.array(True)
    return cfg, jax.jit(lambda s, a, b, q: jpipe.step(cfg, s, a, b, gate, seq=q))


def _seqs(T, N, start=0):
    """Contiguous uint32 seqnums from ``start + 1``, wrapping at 2^32."""
    s = (start + 1 + np.arange(T, dtype=np.int64))[:, None] % 2**32
    return np.broadcast_to(s, (T, N)).astype(np.uint32)


def _compare_steps(jax_step, jstate, tstate, sig, ref, seqs, blocks):
    _, jstep = jax_step
    cfg = PipelineConfig(n_channels=3, block_len=L, **FUSED)
    for t in blocks:
        jstate, jout = jstep(jstate, jnp.asarray(sig[t]), jnp.asarray(ref[t]),
                             jnp.asarray(seqs[t]))
        tstate, tout = step(cfg, tstate, torch.from_numpy(sig[t]), torch.from_numpy(ref[t]),
                            True, seq=seqs[t])
        np.testing.assert_allclose(tstate.delay.numpy(), np.asarray(jstate.delay), atol=2e-3)
        np.testing.assert_allclose(tout.telemetry.lag.numpy(), np.asarray(jout.telemetry.lag),
                                   atol=2e-3)
        _assert_wire_close(tout.wire.numpy(), np.asarray(jout.wire))
        np.testing.assert_array_equal(tout.wire_ref.numpy(), np.asarray(jout.wire_ref))
        np.testing.assert_array_equal(tstate.synced.numpy(), np.asarray(jstate.synced))
        np.testing.assert_array_equal(tstate.gaps.numpy(), np.asarray(jstate.gaps))
        np.testing.assert_array_equal(tstate.last_seq.numpy(),
                                      np.asarray(jstate.last_seq).astype(np.int64))
    return jstate, tstate


def test_step_matches_jax_block_by_block(stream, jax_step):
    sig, ref = stream
    jcfg, _ = jax_step
    seqs = _seqs(10, 3, start=2**32 - 4)   # crosses 2^31.. and wraps at 2^32
    cfg = PipelineConfig(n_channels=3, block_len=L, **FUSED)
    jstate, tstate = _compare_steps(jax_step, jpipe.init_state(jcfg), init_state(cfg, "cpu"),
                                    sig, ref, seqs, range(10))
    assert tstate.synced.all() and int(tstate.block_idx) == 10


def test_step_from_jax_midstream_state(stream, jax_step):
    """Both steps started from the same mid-stream JAX state."""
    sig, ref = stream
    jcfg, jstep = jax_step
    seqs = _seqs(10, 3)
    jstate = jpipe.init_state(jcfg)
    for t in range(5):
        jstate, _ = jstep(jstate, jnp.asarray(sig[t]), jnp.asarray(ref[t]), jnp.asarray(seqs[t]))
    tstate = state_from_numpy(jstate, "cpu")
    _compare_steps(jax_step, jstate, tstate, sig, ref, seqs, range(5, 8))


def test_step_gap_policy():
    """A seqnum gap bumps the counter, desyncs the channel, freezes its
    phase, and the channel re-locks (tests/test_kernels.py:354-388)."""
    truth = make_truth(3, seed=8, max_delay=10.0, snr_db=30.0)
    cap = synth_capture(torch.Generator().manual_seed(8), truth, n_blocks=8, block_len=L)
    cfg = PipelineConfig(n_channels=3, block_len=L, **FUSED)
    state = init_state(cfg, "cpu")
    seq = np.zeros(3, np.uint32)
    for t in range(8):
        seq = seq + 1
        if t == 5:
            seq[1] += 3   # dropped buffers on channel 1
        state, out = step(cfg, state, cap.sig_u8[t], cap.ref_u8[t], True, seq=seq)
        if t == 4:
            phase_before = state.phase.clone()
        if t == 5:
            assert bool(out.telemetry.gap[1]) and not bool(out.telemetry.gap[0])
            assert not bool(state.synced[1])
            assert torch.equal(state.phase[1], phase_before[1])
    assert state.gaps.tolist() == [0, 1, 0]
    assert bool(state.synced[1])   # re-locked after the gap
    np.testing.assert_allclose(state.delay.numpy(), truth.delays, atol=0.1)


def test_packed_runners_equal_the_step_loop(stream):
    sig, ref = (torch.from_numpy(x) for x in stream)
    cfg = PipelineConfig(n_channels=3, block_len=L, **FUSED)
    seqs = _seqs(8, 3, start=2**32 - 3)
    state = init_state(cfg, "cpu")
    wires, telems = [], []
    for t in range(8):
        state, out = step(cfg, state, sig[t], ref[t], True, seq=seqs[t])
        wires.append(out.wire)
        telems.append(out.telemetry)

    run = make_packed_scan_runner(cfg)
    pstate = pack_state(init_state(cfg, "cpu"))
    got_w, got_t = [], []
    for c in range(2):   # two calls of K = 4 blocks
        blk = slice(4 * c, 4 * c + 4)
        pstate, (w, wr), tel = run(pstate, sig[blk], ref[blk], True, seqs[blk])
        assert tuple(w.shape) == (4, 3, 2 * L) and tuple(wr.shape) == (4, 2 * L)
        assert tuple(tel.shape) == (4, 3, 10)
        got_w.append(w)
        got_t.append(tel)
    assert torch.equal(torch.cat(got_w), torch.stack(wires))
    for a, b in zip(pack_state(state), pstate):
        assert torch.equal(a, b)
    assert torch.equal(torch.cat(got_t)[:, :, 0], torch.stack([t.lag for t in telems]))

    one = make_packed_step(cfg)
    p1 = pack_state(init_state(cfg, "cpu"))
    p1, w1, wr1, tel1 = one(p1, sig[0], ref[0], True, seqs[0])
    assert torch.equal(w1, wires[0]) and tuple(tel1.shape) == (3, 10)

    s2, w2, wr2, tel2 = run_capture(cfg, init_state(cfg, "cpu"), sig[:8], ref[:8])
    assert torch.equal(w2, torch.stack(wires)) and tuple(tel2.lag.shape) == (8, 3)


@pytest.mark.parametrize("smoothing", ["global", "ema"])
def test_align_offline_matches_jax(smoothing):
    truth = jax_make_truth(4, seed=4, max_delay=30.0, snr_db=30.0)
    cap = jax_synth_capture(jax.random.PRNGKey(4), truth, n_blocks=8, block_len=L)
    sig, ref = np.array(cap.sig_u8), np.array(cap.ref_u8)
    jcfg = jpipe.PipelineConfig(n_channels=4, block_len=L, **FUSED)
    jr = jax.jit(lambda s, r: jpipe.align_offline(jcfg, s, r, smoothing=smoothing))(
        jnp.asarray(sig), jnp.asarray(ref))
    cfg = PipelineConfig(n_channels=4, block_len=L, **FUSED)
    tr = align_offline(cfg, torch.from_numpy(sig), torch.from_numpy(ref), smoothing=smoothing)
    np.testing.assert_allclose(tr.delay.numpy(), np.asarray(jr.delay), atol=2e-3)
    np.testing.assert_allclose(tr.lag.numpy(), np.asarray(jr.lag), atol=1e-3)
    np.testing.assert_allclose(tr.phase.numpy(), np.asarray(jr.phase), atol=1e-3)
    _assert_wire_close(tr.wire.numpy(), np.asarray(jr.wire))
    np.testing.assert_array_equal(tr.wire_ref.numpy(), np.asarray(jr.wire_ref))
    assert tuple(tr.aligned.shape) == (7, 4, L) and tuple(tr.ref.shape) == (7, L)


def test_synth_capture_truth_is_recovered():
    truth = make_truth(3, seed=5, max_delay=30.0, snr_db=30.0)
    cap = synth_capture(torch.Generator().manual_seed(5), truth, n_blocks=8, block_len=L)
    assert cap.sig_u8.dtype == torch.uint8 and tuple(cap.sig_u8.shape) == (8, 3, L, 2)
    cfg = PipelineConfig(n_channels=3, block_len=L, **FUSED)
    res = align_offline(cfg, cap.sig_u8, cap.ref_u8)
    np.testing.assert_allclose(res.delay.numpy()[0], truth.delays, atol=0.1)
    # Residual phase of each aligned channel against the reference.
    z = (res.aligned * res.ref[:, None].conj()).sum(-1)
    assert np.degrees(np.abs(np.angle(z.numpy()))).max() < 1.0
    np.testing.assert_array_equal(make_truth(3, seed=5).delays,
                                  jax_make_truth(3, seed=5).delays)


def test_unported_paths_raise():
    """What the port does not run raises instead of running something else:
    a lag method the backend does not have, a length the four-step cannot
    take. ppm != 0 in the synthesizer runs (the Farrow interpolator): at
    ~1 ppm over two blocks the skew moves the bytes by at most 1 LSB from
    the same draw without it."""
    skew = make_truth(2, max_ppm=1.0)
    assert np.all(skew.ppm != 0)
    cap = synth_capture(torch.Generator().manual_seed(0), skew, 2, L)
    flat = synth_capture(torch.Generator().manual_seed(0),
                         dataclasses.replace(skew, ppm=np.zeros(2, np.float32)), 2, L)
    assert tuple(cap.sig_u8.shape) == (2, 2, L, 2) and torch.equal(cap.ref_u8, flat.ref_u8)
    d = (cap.sig_u8.int() - flat.sig_u8.int()).abs()
    assert d.max().item() <= 1 and d.sum().item() > 0
    x = torch.zeros((2, 2, L, 2), dtype=torch.uint8)
    bad = PipelineConfig(n_channels=2, block_len=L, fft_impl="fused")   # phase_slope
    with pytest.raises(ValueError, match="phase_zoom"):
        step(bad, init_state(bad, "cpu"), x[0], x[0, 0], True)
    parab = PipelineConfig(n_channels=2, block_len=L, fft_impl="pallas", lag_method="parabolic")
    with pytest.raises(ValueError, match="unsupported method"):
        align_offline(parab, x, x[:, 0])
    with pytest.raises(ValueError, match="unknown fractional-lag method"):
        align_offline(PipelineConfig(n_channels=2, block_len=L, lag_method="nope"), x, x[:, 0])
    odd = PipelineConfig(n_channels=2, block_len=1000, fft_impl="mxu")
    with pytest.raises(ValueError, match="square"):
        align_offline(odd, torch.zeros((2, 2, 1000, 2), dtype=torch.uint8),
                      torch.zeros((2, 1000, 2), dtype=torch.uint8))
