"""The benchmark's frozen copies against the port's originals, at a small
size (W = 4096), and the plain reference against the port's plain path."""

import numpy as np
import pytest
import torch

import _tiny  # noqa: F401  (puts the checkout on sys.path)
from portbench import cost_model, synth, wire
from portbench.reference import align

from coherent_rtlsdr_tpu_torch.io import wire as port_wire
from coherent_rtlsdr_tpu_torch.kernels.fft4step import bf16_round
from coherent_rtlsdr_tpu_torch.ops import delay as port_delay
from coherent_rtlsdr_tpu_torch.signal import synth as port_synth
from coherent_rtlsdr_tpu_torch.tools import cost_model as port_cost


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_make_truth(seed):
    a = synth.make_truth(5, seed=seed, max_delay=40.0, snr_db=30.0)
    b = port_synth.make_truth(5, seed=seed, max_delay=40.0, snr_db=30.0)
    for f in ("delays", "phases", "gains", "ppm"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_delay_ramp_and_quantize():
    d = torch.tensor([0.0, 3.25, -17.5, 40.0])
    torch.testing.assert_close(synth.delay_ramp(4096, d), port_delay.delay_ramp(4096, d),
                               rtol=0, atol=0)
    x = torch.complex(torch.randn(3, 64), torch.randn(3, 64)) * 0.4
    assert torch.equal(synth.quantize_u8(x), port_synth.quantize_u8(x))


@pytest.mark.parametrize("slab,max_ppm", [(0, 0.0), (3, 0.0), (0, 0.1), (2, 20.0)])
def test_synth_stream_slab(slab, max_ppm):
    t = synth.make_truth(3, seed=11, max_ppm=max_ppm)
    a = synth.synth_stream_slab(11, t, slab, 2, 2048, device="cpu")
    b = port_synth.synth_stream_slab(11, port_synth.make_truth(3, seed=11, max_ppm=max_ppm),
                                     slab, 2, 2048, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_farrow_copy():
    x = torch.complex(torch.randn(3, 4096), torch.randn(3, 4096))
    for adv in (torch.tensor(0.3), torch.tensor([0.1, -0.7, 2.25]),
                -torch.tensor([0.5, -1.0, 2.0])[:, None] * 1e-4 * torch.arange(4096.0)):
        assert torch.equal(synth.farrow_fractional_delay(x, adv),
                           port_delay.farrow_fractional_delay(x, adv))


def test_periodic_stream_wraps_like_any_boundary():
    """An integer delay of the periodic stream is a circular shift: the
    samples after the wrap come from the end of the period."""
    ref = torch.complex(torch.randn(4 * 1024, dtype=torch.float32),
                        torch.randn(4 * 1024, dtype=torch.float32))
    d = torch.tensor([0.0, 5.0, -13.0, 40.0])
    got = synth.periodic_delay(ref, d)
    for i, k in enumerate([0, 5, -13, 40]):
        torch.testing.assert_close(got[i], torch.roll(ref, k), rtol=0, atol=2e-5)


def test_render_periodic_is_one_period():
    t = synth.make_truth(3, seed=4)
    sig, ref = synth.render_periodic(4, t, 8, 2048, device="cpu")
    assert sig.shape == (8, 3, 2048, 2) and ref.shape == (8, 2048, 2)
    assert sig.dtype == torch.uint8 and ref.dtype == torch.uint8
    sig2, ref2 = synth.render_periodic(4, t, 8, 2048, device="cpu")
    assert torch.equal(sig, sig2) and torch.equal(ref, ref2)


def test_wire_copy():
    rng = np.random.default_rng(1)
    iq = rng.integers(-128, 128, (4, 2048, 2), dtype=np.int8)
    seq = np.array([5, 5, 6, 7], np.uint32)
    buf = wire.pack_frame(12, seq, iq)
    assert buf == port_wire.pack_frame(12, seq, iq)
    f, g = wire.unpack_frame(buf), port_wire.unpack_frame(buf)
    assert f.globalseqn == g.globalseqn
    np.testing.assert_array_equal(f.iq, g.iq)
    np.testing.assert_array_equal(f.seqnums, g.seqnums)
    ph = np.exp(1j * rng.uniform(-3, 3, 4)).astype(np.complex64)
    assert wire.pack_debug(ph) == port_wire.pack_debug(ph)


@pytest.mark.parametrize("T,N,m", [(256, 21, 128), (64, 21, 256), (5, 3, 64)])
def test_cost_model_copy(T, N, m):
    assert cost_model.measure_ref(T, m) == tuple(port_cost.measure_ref(T, m))
    assert cost_model.measure_i8_spec(T, N, m) == tuple(port_cost.measure_i8_spec(T, N, m))
    assert cost_model.apply_spec_i8(T, N, m) == tuple(port_cost.apply_spec_i8(T, N, m))
    for f in (cost_model.measure_ref(T, m), cost_model.apply_spec_i8(T, N, m)):
        ms, _ = port_cost.bound(port_cost.Cost(*f))
        assert cost_model.bound_s(f) == pytest.approx(ms * 1e-3, rel=1e-12)


def test_round_mantissa_is_bf16_at_7_bits():
    x = torch.randn(10000) * torch.logspace(-6, 6, 10000)
    assert torch.equal(align.round_mantissa(x, 7), bf16_round(x))


def test_reference_against_the_port_plain_path():
    """The float64 reference and the port's plain (bf16) path agree as the
    cells' limits require; the fp8 control does not."""
    from coherent_rtlsdr_tpu_torch.pipeline.offline import align_offline
    from coherent_rtlsdr_tpu_torch.pipeline.state import PipelineConfig
    from portbench.reference import compare

    L, N, T = 2048, 3, 8
    t = synth.make_truth(N, seed=9)
    sig, ref = synth.render_periodic(9, t, T, L, device="cpu")
    got = align_offline(PipelineConfig(n_channels=N, block_len=L, fft_impl="fused",
                                       lag_method="phase_zoom"), sig, ref)
    p = align.Params(dict(block_len=L, ctrl_gain=0.9, ctrl_scale=100.0, phase_alpha=0.5,
                          min_corr_mag=0.1))
    r = compare.Readings()
    compare.offline(r, got, align.align_offline(align.Transform(2 * L, "cpu", "f64"), p, sig, ref))
    v = r.values()
    assert v["ref_bytes_differ"] == 0 and v["wire_max_lsb"] <= 1 and v["wire_rms_lsb"] < 0.4
    assert v["delay_max"] < 1e-4 and v["phase_max_deg"] < 0.01
