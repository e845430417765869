"""The port's Farrow interpolator against the JAX package's, and the port's
continuous synthetic stream, clock-skew synthesis and stream source (CPU).

Bars: Farrow atol 1e-5 against the JAX function on the same complex64
input (float32 coefficients and sums in both); the stream's reference
bytes exactly equal across slab seams and its signal bytes within 1 LSB on
>= 99.9 % of the samples (the receiver noise is drawn per slab, hence the
60 dB truth), as the JAX package's own tests hold its stream
(tests/test_server.py:304-360); skew tracking by the JAX package's bars
(tests/test_pipeline.py:121-155).
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.ops import delay as jdelay
from coherent_rtlsdr_tpu_torch.ops import delay as tdelay
from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig, init_state, step
from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_capture, synth_stream_slab
from coherent_rtlsdr_tpu_torch.signal.sources import SyntheticStreamSource

FARROW_ATOL = 1e-5


def _c64(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("kind", ["scalar", "per_batch", "per_sample", "per_sample_shared"])
def test_farrow_matches_jax(kind):
    """Scalar, per-batch [B] and per-sample [B, T] advances on x [B, T],
    and a per-sample [T] advance on x [T], with integer parts of both signs
    (indices wrap circularly)."""
    rng = np.random.default_rng(11)
    x = _c64(rng, (512,) if kind == "per_sample_shared" else (3, 512))
    adv = {
        "scalar": np.float32(2.37),
        "per_batch": np.array([-5.25, 0.5, 13.875], np.float32),
        "per_sample": (rng.uniform(-3, 3, (3, 512))
                       + np.linspace(-20, 20, 512)).astype(np.float32),
        "per_sample_shared": np.linspace(-1.5, 7.25, 512).astype(np.float32),
    }[kind]
    got = tdelay.farrow_fractional_delay(torch.from_numpy(x), torch.from_numpy(np.asarray(adv)))
    want = np.asarray(jdelay.farrow_fractional_delay(jnp.asarray(x), jnp.asarray(adv)))
    assert got.dtype == torch.complex64 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FARROW_ATOL)
    for a, b in zip(tdelay._farrow_coeffs(torch.tensor([0.0, 0.3, 0.99])),
                    jdelay._farrow_coeffs(jnp.asarray([0.0, 0.3, 0.99]))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)


def test_farrow_integer_advance_is_a_circular_shift():
    x = torch.from_numpy(_c64(np.random.default_rng(1), (2, 64)))
    torch.testing.assert_close(tdelay.farrow_fractional_delay(x, 3.0), torch.roll(x, -3, -1),
                               rtol=0, atol=0)


class TestStreamContinuity:
    """The synthetic stream is continuous across slab seams."""

    def test_ref_blocks_deterministic_across_slabs(self):
        truth = make_truth(2, seed=7, max_delay=40.0, snr_db=30.0)
        _, ref_a = synth_stream_slab(7, truth, 0, 4, block_len=1024, device="cpu")
        _, ref_b = synth_stream_slab(7, truth, 1, 4, block_len=1024, device="cpu")
        _, ref_big = synth_stream_slab(7, truth, 0, 8, block_len=1024, device="cpu")
        assert ref_a.dtype == torch.uint8 and tuple(ref_a.shape) == (4, 1024, 2)
        assert torch.equal(ref_a, ref_big[:4]) and torch.equal(ref_b, ref_big[4:])

    def test_signal_channels_continuous_at_seam(self):
        truth = make_truth(3, seed=8, max_delay=40.0, snr_db=60.0)
        truth = dataclasses.replace(truth, ppm=np.array([30.0, -20.0, 0.0], np.float32))
        sig_a, _ = synth_stream_slab(8, truth, 0, 4, block_len=1024, device="cpu")
        sig_b, _ = synth_stream_slab(8, truth, 1, 4, block_len=1024, device="cpu")
        sig_big, _ = synth_stream_slab(8, truth, 0, 8, block_len=1024, device="cpu")
        assert tuple(sig_big.shape) == (8, 3, 1024, 2)
        a = torch.cat([sig_a, sig_b]).to(torch.int16)
        close = (a - sig_big.to(torch.int16)).abs() <= 1
        assert close.float().mean().item() > 0.999

    def test_no_correlation_dip_at_slab_boundary(self):
        """The step's aligned output correlates with the reference on every
        block, the windows that span slab seams (t = 8, 12) included."""
        truth = make_truth(3, seed=5, max_delay=40.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=2048, slab_blocks=4, seed=5, device="cpu")
        cfg = PipelineConfig(n_channels=3, block_len=2048)
        state = init_state(cfg, "cpu")
        worst = 1.0
        for t in range(13):
            sig, ref, _ = src.next_block()
            state, out = step(cfg, state, torch.from_numpy(sig), torch.from_numpy(ref), True)
            if t >= 5:
                a, r = out.aligned, out.ref
                rho = (a * r.conj()).sum(-1).abs() / (a.norm(dim=-1) * r.norm())
                worst = min(worst, rho.min().item())
        assert worst > 0.995, worst


def test_synth_capture_with_clock_skew_tracks():
    """Residual ppm skew drifts the true delay continuously; the control
    loop tracks it (the JAX package's test, tests/test_pipeline.py:121-155,
    on the port's synthesizer and step)."""
    L, n_blocks = 2048, 24
    truth = dataclasses.replace(make_truth(3, seed=6, max_delay=10.0, snr_db=30.0),
                                ppm=np.array([50.0, -40.0, 25.0], np.float32))
    cap = synth_capture(torch.Generator().manual_seed(6), truth, n_blocks=n_blocks, block_len=L)
    cfg = PipelineConfig(n_channels=3, block_len=L)
    state = init_state(cfg, "cpu")
    errs = []
    for t in range(n_blocks):
        state, _ = step(cfg, state, cap.sig_u8[t], cap.ref_u8[t], True)
        true_now = truth.delays + truth.ppm * 1e-6 * (t * L)
        if t >= 6:
            errs.append(np.abs(state.delay.numpy() - true_now))
    errs = np.stack(errs)
    assert errs.max() < 0.35, errs.max()
    assert errs.mean() < 0.15, errs.mean()


def test_stream_source_serves_blocks_and_survives_a_seam_hot_plug():
    """Seqnums advance by one a block; a hot add exactly at a slab seam
    resumes the reference timeline where it stopped; drops repeat a
    channel's previous block and skip its seqnum."""
    truth = make_truth(2, seed=13, max_delay=20.0, snr_db=30.0)
    src = SyntheticStreamSource(truth, block_len=1024, slab_blocks=4, seed=13, device="cpu")
    for i in range(4):
        sig, ref, seqs = src.next_block()
        assert sig.dtype == np.uint8 and sig.shape == (2, 1024, 2) and ref.shape == (1024, 2)
        np.testing.assert_array_equal(seqs, [i + 1, i + 1])
    assert src.add_channel("SEAM_X") == 2 and src.serials[-1] == "SEAM_X"
    blk = src.next_block()
    assert blk[0].shape[0] == 3
    src2 = SyntheticStreamSource(truth, block_len=1024, slab_blocks=4, seed=13, device="cpu")
    for _ in range(4):
        src2.next_block()
    np.testing.assert_array_equal(blk[1], src2.next_block()[1])
    assert src.del_channel("SYN 0") == 0 and src.del_channel("NOPE") is None
    assert src.n_channels == 2

    drop = SyntheticStreamSource(truth, block_len=1024, slab_blocks=4, seed=5, drop_rate=0.5,
                                 device="cpu")
    prev = drop.next_block()
    skipped = False
    for _ in range(6):
        cur = drop.next_block()
        d = cur[2].astype(np.int64) - prev[2].astype(np.int64)
        assert set(d.tolist()) <= {1, 2}
        for ch in np.nonzero(d == 2)[0]:
            np.testing.assert_array_equal(cur[0][ch], prev[0][ch])
            skipped = True
        prev = cur
    assert skipped


def test_stream_source_and_slab_default_to_the_card():
    """No device given: the source and the slab render on the card, and
    without one they raise instead of rendering on the CPU."""
    for fn in (SyntheticStreamSource, synth_stream_slab):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        truth = make_truth(2, seed=1)
        with pytest.raises(RuntimeError, match="card"):
            SyntheticStreamSource(truth, block_len=1024)
        with pytest.raises((AssertionError, RuntimeError)):
            synth_stream_slab(0, truth, 0, 2, block_len=1024)
