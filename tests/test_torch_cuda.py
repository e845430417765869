"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so on a machine without them it
runs as ``python -m pytest --noconftest tests/test_torch_cuda.py``.

Bars: lag atol 1e-3 samples and z, mag, papr (|z|, sum |D|^2, sum |G|^2 on
the float path) rtol 1e-3 where the pipeline uses the measurement (mag >=
0.1; on uncorrelated bytes the lag is ill-conditioned, see PERF.md); the
same accept/reject decision everywhere; under 1e-3 of the D elements, and of
the reference spectrum's elements rounded to bf16, more than 1 bf16 ulp
apart; the reference energy rtol 1e-3; wire bytes max |diff| <= 2 LSB with
under 1e-3 of them > 1 LSB, and the float apply's output within the same
bars in float units (2/127, 1/127); the four-step FFT max |diff| / max
|plain| <= 1e-3, and within 3e-2 of torch.fft (tests/test_kernels.py:81);
the block copy bit-equal to its input.
"""

import pytest
import torch

from coherent_rtlsdr_tpu_torch.kernels import fused_cuda
from coherent_rtlsdr_tpu_torch.kernels.backend import get_spectral
from coherent_rtlsdr_tpu_torch.kernels.copy import BlockCopy
from coherent_rtlsdr_tpu_torch.kernels.fourstep import FFT4StepKernel, get_fourstep_kernel
from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels, get_fused_kernels
from coherent_rtlsdr_tpu_torch.ops.convert import i8_iq_to_c64, u8_to_i8
from coherent_rtlsdr_tpu_torch.pipeline.state import PipelineConfig
from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_capture

MIN_CORR_MAG = 0.1   # PipelineConfig.min_corr_mag
T, N = 3, 5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


def _blocks(kind, m, dev, t=T, n=N):
    g = torch.Generator(device=dev).manual_seed(m)
    if kind == "random":
        return (torch.randint(-128, 128, (t, n, m // 2, 2 * m), generator=g, device=dev,
                              dtype=torch.int8),
                torch.randint(-128, 128, (t, m // 2, 2 * m), generator=g, device=dev,
                              dtype=torch.int8))
    cap = synth_capture(g, make_truth(n, seed=m, max_delay=30.0), n_blocks=t,
                        block_len=m * m // 2)
    return (u8_to_i8(cap.sig_u8.reshape(t, n, m // 2, 2 * m)),
            u8_to_i8(cap.ref_u8.reshape(t, m // 2, 2 * m)))


def _ulp_apart(a, b):
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 128, 256])
@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_kernels_match_plain_on_card(kind, m, cuda_device):
    k = FusedPipelineKernels(m * m, cuda_device)
    raw, ref_raw = _blocks(kind, m, cuda_device)
    r_got, e_got = k.measure_ref(ref_raw)
    r_want, e_want = k.measure_ref_plain(ref_raw)
    got = k.measure_spec(raw, r_got, e_got)
    want = k.measure_spec_plain(raw, r_want, e_want)
    torch.cuda.synchronize()
    assert (k.measure_ref_launches, k.measure_spec_launches) == (1, 1)
    assert ((e_got - e_want).abs() <= 1e-3 * e_want).all()
    r_ulp = _ulp_apart(r_got.to(torch.bfloat16), r_want.to(torch.bfloat16))
    assert (r_ulp > 1).float().mean().item() < 1e-3
    for x in got[:5]:
        assert torch.isfinite(x).all()
    used = want[3] >= MIN_CORR_MAG
    assert torch.equal(got[3] >= MIN_CORR_MAG, used)
    assert used.all() if kind == "correlated" else not used.any()
    assert ((got[0] - want[0]).abs()[used] <= 1e-3).all()
    for a, b in zip(got[1:5], want[1:5]):
        assert ((a - b).abs() <= 1e-3 * b.abs())[used].all()
    for a, b in zip(got[5:], want[5:]):
        assert (_ulp_apart(a, b) > 1).float().mean().item() < 1e-3

    adv = torch.linspace(-40, 40, (T - 1) * N, device=cuda_device).reshape(T - 1, N)
    args = (want[5], want[6], adv, torch.cos(adv), torch.sin(adv))
    wk = k.apply_spec_i8(*args)
    wp = k.apply_spec_i8_plain(*args)
    torch.cuda.synchronize()
    assert k.apply_spec_i8_launches == 1
    d = (wk.int() - wp.int()).abs()
    assert d.max().item() <= 2 and (d > 1).float().mean().item() < 1e-3


# (T, N) of the measure kernels' test shapes at m: a streaming step of 21
# channels (the server's block: one window a CTA of the persistent grid), a
# single channel, 26 x 21 windows (no whole wave of CTAs on 132 SMs at any
# m), an offline call of 2,097,152 samples a channel (T = 256 at m = 128:
# ~41 windows a CTA) and 7 x 19 = 133 windows, one more than the 132 CTAs
# of the persistent grid at m = 128.
MEASURE_SHAPES = {"stream": lambda m: (2, 21), "one_channel": lambda m: (3, 1),
                  "ragged": lambda m: (27, 21), "offline": lambda m: (2 ** 22 // (m * m), 21),
                  "odd": lambda m: (8, 19)}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 128, 256])
@pytest.mark.parametrize("shape", list(MEASURE_SHAPES))
def test_measure_kernels_match_plain_at_pipeline_shapes_on_card(shape, m, cuda_device):
    """The three i8 measure entries (reference, channels with and without the
    D store) against their plain versions on correlated bytes at the shapes
    of MEASURE_SHAPES (at m = 256 a window is a cluster of four CTAs)."""
    t, n = MEASURE_SHAPES[shape](m)
    k = FusedPipelineKernels(m * m, cuda_device)
    raw, ref_raw = _blocks("correlated", m, cuda_device, t, n)
    r_got, e_got = k.measure_ref(ref_raw)
    r_want, e_want = k.measure_ref_plain(ref_raw)
    spec = k.measure_spec(raw, r_got, e_got)
    spec_plain = k.measure_spec_plain(raw, r_got, e_got)
    rec = fused_cuda.measure_i8(k, raw, r_got, e_got)
    rec_plain = k.measure_i8_plain(raw, r_got, e_got)
    torch.cuda.synchronize()
    assert k.counts() == dict.fromkeys(k.counts(), 0) | dict(
        measure_ref_launches=1, measure_spec_launches=1, measure_i8_launches=1,
        measure_ref_plain_runs=1, measure_spec_plain_runs=1, measure_i8_plain_runs=1)
    assert r_got.shape == (t - 1, m, m, 2) and torch.isfinite(r_got).all()
    assert ((e_got - e_want).abs() <= 1e-3 * e_want).all()
    r_ulp = _ulp_apart(r_got.to(torch.bfloat16), r_want.to(torch.bfloat16))
    assert (r_ulp > 1).float().mean().item() < 1e-3
    assert spec[5].shape == (t - 1, n, m, m) and len(rec) == 5
    for got, want in ((spec, spec_plain), (rec, rec_plain)):
        for x in got[:5]:
            assert x.shape == (t - 1, n) and torch.isfinite(x).all()
        used = want[3] >= MIN_CORR_MAG
        assert used.all() and torch.equal(got[3] >= MIN_CORR_MAG, used)
        assert ((got[0] - want[0]).abs() <= 1e-3).all()
        for a, b in zip(got[1:5], want[1:5]):
            assert ((a - b).abs() <= 1e-3 * b.abs()).all()
    for a, b in zip(spec[5:], spec_plain[5:]):
        assert (_ulp_apart(a, b) > 1).float().mean().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 128, 256])
@pytest.mark.parametrize("shape", ["stream", "odd"])
def test_measure_kernels_replay_in_cuda_graph_on_card(shape, m, cuda_device):
    """Both i8 channel measures captured in a CUDA graph, as the server's
    graphed step captures them, then replayed on other bytes in the
    captured input: the outputs of the eager launches on those bytes, bit
    for bit (the persistent grid's fixed schedule keeps no state between
    launches)."""
    t, n = MEASURE_SHAPES[shape](m)
    k = FusedPipelineKernels(m * m, cuda_device)
    raw, ref_raw = _blocks("correlated", m, cuda_device, t, n)
    R, eref = k.measure_ref(ref_raw)
    static = raw.clone()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        k.measure_spec(static, R, eref)
        fused_cuda.measure_i8(k, static, R, eref)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        spec = k.measure_spec(static, R, eref)
        rec = fused_cuda.measure_i8(k, static, R, eref)
    other = torch.roll(raw, 1, dims=1).contiguous()   # each channel's bytes on another's place
    static.copy_(other)
    graph.replay()
    want_spec = k.measure_spec(other, R, eref)
    want_rec = fused_cuda.measure_i8(k, other, R, eref)
    torch.cuda.synchronize()
    for got, want in zip(spec + rec, want_spec + want_rec):
        assert torch.equal(got, want)
    assert not torch.equal(spec[0], k.measure_spec(raw, R, eref)[0])


@pytest.mark.cuda
def test_measure_kernels_use_no_stack_on_card(cuda_device):
    """ptxas: the twenty-seven tensor-core instantiations use no stack
    frame and spill nothing: twelve measure ones ({reference, i8 channels
    with and without D, float channels} x m in {64, 128, 256}, the m = 256
    ones cluster kernels), nine apply ones ({i8 handoff, i8 recompute,
    float} x m in {64, 128, 256}) and six four-step ones (forward and
    inverse x m in {64, 128, 256})."""
    report = fused_cuda.build()
    for src, names in fused_cuda.TC_KERNELS.items():
        usage = fused_cuda.ptxas_usage(report[src])
        for name in names:
            assert (usage[name]["stack"], usage[name]["spill_stores"],
                    usage[name]["spill_loads"]) == (0, 0, 0), (name, usage[name])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 128, 256])
@pytest.mark.parametrize("shape", ["stream", "one_channel", "ragged"])
def test_apply_kernels_match_plain_at_pipeline_shapes_on_card(shape, m, cuda_device):
    """Both i8 apply kernels (the handoff's persistent grid and the
    recompute kernel or, at m = 256, their cluster kernels) against their
    plain versions by the wire bars, on correlated bytes: one window of 21
    channels (a streaming step), a single channel, and 26 x 21 windows, no
    whole number of rounds of the persistent grid; among the advances a
    large negative and a fractional one."""
    t, n = {"stream": (2, 21), "one_channel": (3, 1), "ragged": (27, 21)}[shape]
    k = FusedPipelineKernels(m * m, cuda_device)
    raw, ref_raw = _blocks("correlated", m, cuda_device, t, n)
    spec = k.measure_spec_plain(raw, *k.measure_ref_plain(ref_raw))
    g = torch.Generator(device=cuda_device).manual_seed(m + t)
    adv = (torch.rand((t - 1, n), generator=g, device=cuda_device) - 0.5) * 80.0
    adv.view(-1)[0] = -1500.25
    adv.view(-1)[-1] = 1023.5
    ph = torch.rand((t - 1, n), generator=g, device=cuda_device) * 6.283185307179586
    args = (adv, torch.cos(ph), torch.sin(ph))
    k.reset_counts()
    pairs = [(k.apply_spec_i8(spec[5], spec[6], *args),
              k.apply_spec_i8_plain(spec[5], spec[6], *args)),
             (k.apply_i8(raw, *args), k.apply_i8_plain(raw, *args))]
    torch.cuda.synchronize()
    assert k.counts() == dict.fromkeys(k.counts(), 0) | dict(
        apply_spec_i8_launches=1, apply_spec_i8_plain_runs=1, apply_i8_launches=1,
        apply_i8_plain_runs=1)
    for got, want in pairs:
        assert got.dtype == torch.int8 and got.shape == (t - 1, n, m // 2, 2 * m)
        assert want.int().abs().max().item() >= 8
        d = (got.int() - want.int()).abs()
        assert d.max().item() <= 2 and (d > 1).float().mean().item() < 1e-3


def _spec_apply_args(m, t, n, dev):
    """The bf16 spectra D of correlated bytes (the plain measure's) and
    advances (among them a large negative and a fractional one) and phase
    factors for ``apply_spec_i8`` at T = t blocks of n channels."""
    k = FusedPipelineKernels(m * m, dev)
    raw, ref_raw = _blocks("correlated", m, dev, t, n)
    spec = k.measure_spec_plain(raw, *k.measure_ref_plain(ref_raw))
    g = torch.Generator(device=dev).manual_seed(m + t)
    adv = (torch.rand((t - 1, n), generator=g, device=dev) - 0.5) * 80.0
    adv.view(-1)[0] = -1500.25
    adv.view(-1)[-1] = 1023.5
    ph = torch.rand((t - 1, n), generator=g, device=dev) * 6.283185307179586
    k.reset_counts()
    return k, (spec[5], spec[6], adv, torch.cos(ph), torch.sin(ph))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 128])
def test_apply_spec_kernel_matches_plain_at_offline_shape_on_card(m, cuda_device):
    """The persistent handoff apply at an offline call's shape (2,097,152
    samples a channel, 21 channels: at m = 128 T = 256, 5,355 windows, ~41
    a CTA of the grid), so that both window buffers change hands many times:
    one launch, the wire bars against the plain version."""
    t, n = MEASURE_SHAPES["offline"](m)
    k, args = _spec_apply_args(m, t, n, cuda_device)
    got = k.apply_spec_i8(*args)
    want = k.apply_spec_i8_plain(*args)
    torch.cuda.synchronize()
    assert (k.apply_spec_i8_launches, k.apply_spec_i8_plain_runs) == (1, 1)
    assert got.dtype == torch.int8 and got.shape == (t - 1, n, m // 2, 2 * m)
    assert want.int().abs().max().item() >= 8
    d = (got.int() - want.int()).abs()
    assert d.max().item() <= 2 and (d > 1).float().mean().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 128, 256])
def test_apply_spec_kernel_replays_in_cuda_graph_on_card(m, cuda_device):
    """The handoff apply captured in a CUDA graph at the flood's shape (one
    server block of 21 channels), as the server's graphed step captures it,
    then replayed on other spectra in the captured input: the eager
    launch's wire bytes on those spectra, bit for bit."""
    k, (dre, dim, *rest) = _spec_apply_args(m, MEASURE_SHAPES["stream"](m)[0], 21, cuda_device)
    static = [dre.clone(), dim.clone()]
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        k.apply_spec_i8(*static, *rest)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        wire = k.apply_spec_i8(*static, *rest)
    other = [torch.roll(x, 1, dims=1).contiguous() for x in (dre, dim)]
    for s, o in zip(static, other):
        s.copy_(o)
    graph.replay()
    want = k.apply_spec_i8(*other, *rest)
    torch.cuda.synchronize()
    assert torch.equal(wire, want)
    assert not torch.equal(wire, k.apply_spec_i8(dre, dim, *rest))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_rows_4_to_7_match_plain_at_m256_on_card(kind, cuda_device):
    """At m = 256 the entries of kernel table rows 4-7 (the recompute apply,
    the four-step forward and inverse, the float measure and apply) run
    their cluster kernels, one launch a call and no plain version, each
    within its bars of its plain version: the wire bars, the four-step's
    1e-3 of the plain version's largest element (and 3e-2 of torch.fft's),
    the float pair's measure and float wire bars."""
    m = 256
    k = FusedPipelineKernels(m * m, cuda_device)
    fk = FFT4StepKernel(m * m, cuda_device)
    raw, ref_raw = _blocks(kind, m, cuda_device)
    adv = _advances(T - 1, N, m, cuda_device)
    ph = torch.rand((T - 1, N), device=cuda_device) * 6.283185307179586
    args = (adv, torch.cos(ph), torch.sin(ph))
    wk = k.apply_i8(raw, *args)
    wp = k.apply_i8_plain(raw, *args)
    torch.cuda.synchronize()
    assert k.counts() == dict.fromkeys(k.counts(), 0) | dict(apply_i8_launches=1,
                                                              apply_i8_plain_runs=1)
    assert wk.dtype == torch.int8 and wk.shape == (T - 1, N, m // 2, 2 * m)
    d = (wk.int() - wp.int()).abs()
    assert d.max().item() <= 2 and (d > 1).float().mean().item() < 1e-3

    sig = i8_iq_to_c64(raw.reshape(T, N, m * m // 2, 2))
    x = torch.cat([sig[:-1], sig[1:]], dim=-1).reshape(-1, m * m)
    X = torch.fft.fft(x).reshape(-1, m, m).transpose(-1, -2)   # natural -> (k2, k1)
    for got, want, lib in ((fk.fft(x), fk.fft_plain(x), X), (fk.ifft(X), fk.ifft_plain(X), x)):
        assert got.shape == want.shape and got.dtype == torch.complex64
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-3
        assert ((got - lib).abs().max() / lib.abs().max()).item() < 3e-2
    assert fk.counts() == dict(fft_launches=1, ifft_launches=1, fft_plain_runs=1,
                               ifft_plain_runs=1)
    _hold_float_pair(k, _planes(raw, ref_raw, m), adv, kind)


@pytest.mark.cuda
def test_plain_versions_restore_tf32(cuda_device):
    k = FusedPipelineKernels(64 * 64, cuda_device)
    raw, ref_raw = _blocks("random", 64, cuda_device)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            k.measure_i8_spec_plain(raw, ref_raw)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _planes(raw, ref_raw, m):
    """Float-path inputs from signed blocks: bf16 block planes [T, N, m/2, m]
    and the bf16 reference window spectra [T-1, m, m] (plain four-step)."""
    t, n, L = raw.shape[0], raw.shape[1], m * m // 2
    sig = i8_iq_to_c64(raw.reshape(t, n, L, 2)).reshape(t, n, m // 2, m)
    ref = i8_iq_to_c64(ref_raw.reshape(t, L, 2))
    R = FFT4StepKernel(m * m, raw.device).fft_plain(torch.cat([ref[:-1], ref[1:]], dim=-1))
    bf = lambda x: x.to(torch.bfloat16)
    return bf(sig.real), bf(sig.imag), bf(R.real), bf(R.imag)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_matches_plain_on_card(inverse, m, cuda_device):
    k = FFT4StepKernel(m * m, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.complex(torch.randn((7, m * m), generator=g, device=cuda_device),
                      torch.randn((7, m * m), generator=g, device=cuda_device))
    X = torch.fft.fft(x).reshape(7, m, m).transpose(-1, -2)   # natural -> (k2, k1)
    if inverse:
        got, want, lib = k.ifft(X), k.ifft_plain(X), x
    else:
        got, want, lib = k.fft(x), k.fft_plain(x), X
    torch.cuda.synchronize()
    assert k.counts() == dict(fft_launches=int(not inverse), ifft_launches=int(inverse),
                              fft_plain_runs=int(not inverse), ifft_plain_runs=int(inverse))
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-3
    assert ((got - lib).abs().max() / lib.abs().max()).item() < 3e-2


def _hold_float_pair(k, planes, adv, kind):
    """The float measure and apply kernels against their plain versions on
    the same planes and advances, by the i8 measure bars and the wire bars
    in float units."""
    pre, pim, rre, rim = planes
    t1, n = adv.shape
    m = k.m
    k.reset_counts()
    got = k.measure(pre, pim, rre, rim)
    want = k.measure_plain(pre, pim, rre, rim)
    yk = k.apply(pre, pim, adv)
    yp = k.apply_plain(pre, pim, adv)
    torch.cuda.synchronize()
    assert k.counts() == dict.fromkeys(k.counts(), 0) | dict(
        measure_launches=1, measure_plain_runs=1, apply_launches=1, apply_plain_runs=1)
    eref = (rre.float() ** 2 + rim.float() ** 2).sum((-2, -1))[:, None]
    mag = lambda out: out[1] / torch.sqrt(out[2] * eref)
    used = mag(want) >= MIN_CORR_MAG
    assert torch.equal(mag(got) >= MIN_CORR_MAG, used)
    assert used.all() if kind == "correlated" else not used.any()
    for x in got:
        assert x.shape == (t1, n) and torch.isfinite(x).all()
    assert ((got[0] - want[0]).abs()[used] <= 1e-3).all()
    for a, b in zip(got[1:], want[1:]):
        assert ((a - b).abs() <= 1e-3 * b.abs())[used].all()
    for a, b in zip(yk, yp):
        assert a.dtype == torch.float32 and a.shape == (t1, n, m * m // 2)
        assert b.abs().max().item() >= 8 / 127   # the comparison sees real samples
        d = (a - b).abs()
        assert d.max().item() <= 2 / 127 and (d > 1 / 127).float().mean().item() < 1e-3


def _advances(t1, n, seed, dev):
    """Advances in [-40, 40) with a large negative and a fractional one
    among the windows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    adv = (torch.rand((t1, n), generator=g, device=dev) - 0.5) * 80.0
    adv.view(-1)[0] = -1500.25
    adv.view(-1)[-1] = 1023.5
    return adv


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 128, 256])
@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_float_kernels_match_plain_on_card(kind, m, cuda_device):
    k = FusedPipelineKernels(m * m, cuda_device)
    planes = _planes(*_blocks(kind, m, cuda_device), m)
    _hold_float_pair(k, planes, _advances(T - 1, N, m, cuda_device), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 128, 256])
@pytest.mark.parametrize("shape", ["stream", "one_channel", "ragged"])
def test_float_kernels_match_plain_at_pipeline_shapes_on_card(shape, m, cuda_device):
    """fused_measure_planes and fused_apply_planes against their plain
    versions on correlated planes: one window of 21 channels (a streaming
    step), a single channel, and 26 x 21 windows, no whole wave of CTAs on
    132 SMs at any m (at m = 256 a window is a cluster of four CTAs); among
    the advances a large negative and a fractional one."""
    t, n = {"stream": (2, 21), "one_channel": (3, 1), "ragged": (27, 21)}[shape]
    k = FusedPipelineKernels(m * m, cuda_device)
    planes = _planes(*_blocks("correlated", m, cuda_device, t, n), m)
    _hold_float_pair(k, planes, _advances(t - 1, n, m + t, cuda_device), "correlated")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 256])
@pytest.mark.parametrize("impl", ["xla", "mxu", "pallas", "fused"])
def test_backends_run_on_card_without_plain_paths(impl, m, cuda_device):
    """Each backend of get_spectral on the card, prepare -> measure ->
    correct: "pallas" launches the four-step kernel (2 forward, 2 inverse),
    "fused" the reference transform and the float measure/apply kernels,
    and no plain version runs."""
    L = m * m // 2
    method = "phase_zoom" if impl == "fused" else "phase_slope"
    cfg = PipelineConfig(n_channels=N, block_len=L, fft_impl=impl, lag_method=method)
    fk, kk = get_fourstep_kernel(m * m, cuda_device), get_fused_kernels(m * m, cuda_device)
    raw, ref_raw = _blocks("correlated", m, cuda_device)
    sig = i8_iq_to_c64(raw.reshape(T, N, L, 2))
    ref = i8_iq_to_c64(ref_raw.reshape(T, L, 2))
    sp = get_spectral(cfg, m * m, cuda_device)
    fk.reset_counts()
    kk.reset_counts()
    ctx = sp.prepare(sig, ref)
    est = sp.measure(ctx, method)
    y = sp.correct(ctx, est.lag)
    torch.cuda.synchronize()
    assert y.shape == (T - 1, N, L) and torch.isfinite(torch.view_as_real(y)).all()
    assert (est.mag > 0.5).all()
    want_fft = dict(fft_launches=2, ifft_launches=2) if impl == "pallas" else (
        dict(fft_launches=1) if impl == "fused" else {})
    want_fused = dict(measure_launches=1, apply_launches=1) if impl == "fused" else {}
    assert fk.counts() == dict.fromkeys(fk.counts(), 0) | want_fft
    assert kk.counts() == dict.fromkeys(kk.counts(), 0) | want_fused


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 128, 256])
@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_recompute_kernels_match_plain_on_card(kind, m, cuda_device):
    """fused_measure_i8 (after fused_measure_ref) and fused_apply_i8 against
    their plain versions, by the bars of the handoff pair's kernels."""
    k = FusedPipelineKernels(m * m, cuda_device)
    raw, ref_raw = _blocks(kind, m, cuda_device)
    got = k.measure_i8(raw, ref_raw)
    # The plain channel half on the kernel's reference spectra, so the
    # channel kernel is held alone (fused_measure_ref: the handoff test).
    want = k.measure_i8_plain(raw, *k.measure_ref(ref_raw))
    torch.cuda.synchronize()
    assert k.counts() == dict.fromkeys(k.counts(), 0) | dict(
        measure_ref_launches=2, measure_i8_launches=1, measure_i8_plain_runs=1)
    assert len(got) == 5
    for x in got:
        assert x.shape == (T - 1, N) and torch.isfinite(x).all()
    used = want[3] >= MIN_CORR_MAG
    assert torch.equal(got[3] >= MIN_CORR_MAG, used)
    assert used.all() if kind == "correlated" else not used.any()
    assert ((got[0] - want[0]).abs()[used] <= 1e-3).all()
    for a, b in zip(got[1:], want[1:]):
        assert ((a - b).abs() <= 1e-3 * b.abs())[used].all()

    adv = torch.linspace(-40, 40, (T - 1) * N, device=cuda_device).reshape(T - 1, N)
    adv[0, 0] = -1500.25   # a large integer part of either sign
    adv[0, 1] = 1023.5
    args = (adv, torch.cos(adv), torch.sin(adv))
    wk = k.apply_i8(raw, *args)
    wp = k.apply_i8_plain(raw, *args)
    torch.cuda.synchronize()
    assert (k.apply_i8_launches, k.apply_i8_plain_runs) == (1, 1)
    assert wk.dtype == torch.int8 and wk.shape == (T - 1, N, m // 2, 2 * m)
    d = (wk.int() - wp.int()).abs()
    assert d.max().item() <= 2 and (d > 1).float().mean().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [1, 7])
def test_copy_blocks_bit_equal_on_card(nc, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(nc)
    x = torch.randint(-128, 128, (4, 21, 64, 256), generator=g, device=cuda_device,
                      dtype=torch.int8)
    c = BlockCopy()
    y = c.copy(x, nc)
    torch.cuda.synchronize()
    assert c.counts() == dict(copy_launches=1, copy_plain_runs=0)
    assert y.data_ptr() != x.data_ptr() and torch.equal(y, x)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("B", [1, 131, 133, 397])
@pytest.mark.parametrize("m", [64, 128])
def test_fourstep_persistent_grid_matches_plain_on_card(m, B, inverse, cuda_device):
    """Batches below, just above and several times the persistent grid of
    132 SMs, with a ragged last round."""
    k = FFT4StepKernel(m * m, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(B)
    x = torch.complex(torch.randn((B, m * m), generator=g, device=cuda_device),
                      torch.randn((B, m * m), generator=g, device=cuda_device))
    X = torch.fft.fft(x).reshape(B, m, m).transpose(-1, -2)   # natural -> (k2, k1)
    got, want, lib = (k.ifft(X), k.ifft_plain(X), x) if inverse else (k.fft(x), k.fft_plain(x), X)
    torch.cuda.synchronize()
    assert k.ifft_launches + k.fft_launches == 1
    rel = lambda a, b: ((a - b).reshape(B, -1).abs().amax(1)
                        / b.reshape(B, -1).abs().amax(1))
    # Every transform of the batch, not only the largest, within the bars.
    assert (rel(got, want) <= 1e-3).all()
    assert (rel(got, lib) < 3e-2).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [1, 3, 7])
@pytest.mark.parametrize("T_blocks", [1, 3])
def test_copy_blocks_small_batches_bit_equal_on_card(T_blocks, nc, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(10 * T_blocks + nc)
    x = torch.randint(-128, 128, (T_blocks, 21, 64, 256), generator=g, device=cuda_device,
                      dtype=torch.int8)
    c = BlockCopy()
    y = c.copy(x, nc)
    torch.cuda.synchronize()
    assert c.counts() == dict(copy_launches=1, copy_plain_runs=0)
    assert torch.equal(y, x)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["misaligned", "non_contiguous"])
@pytest.mark.parametrize("kernel", ["fourstep", "copy_blocks"])
def test_wrappers_raise_on_views_on_card(kernel, view, cuda_device):
    """The four-step and copy wrappers take no view: a base off a 16-byte
    boundary or a non-contiguous tensor raises before any launch."""
    m = 64
    if kernel == "fourstep":
        k = FFT4StepKernel(m * m, cuda_device)
        flat = torch.zeros(2 * m * m + 1, dtype=torch.complex64, device=cuda_device)
        x = (flat[1:].view(2, m, m) if view == "misaligned"
             else flat[:-1].view(2, m, m).transpose(-1, -2))
        with pytest.raises(ValueError):
            fused_cuda.fourstep(k, x, inverse=False)
        assert k.counts()["fft_launches"] == 0
    else:
        c = BlockCopy()
        flat = torch.zeros(2 * 21 * m * m + 16, dtype=torch.int8, device=cuda_device)
        x = (flat[8:8 + 2 * 21 * m * m].view(2, 21, m // 2, 2 * m) if view == "misaligned"
             else flat[:2 * 21 * m * m].view(21, 2, m // 2, 2 * m).transpose(0, 1))
        with pytest.raises(ValueError):
            c.copy(x, 1)
        assert c.counts()["copy_launches"] == 0


class _RecordingPublisher:
    def __init__(self):
        self.frames = []

    def publish(self, iq_i8, seqnums, phases=None):
        self.frames.append((iq_i8.copy(), seqnums.copy()))
        return iq_i8.size


class _NoControl:
    def poll(self, handler, timeout_ms=0):
        return 0


@pytest.mark.cuda
@pytest.mark.parametrize("scan_depth", [1, 4])
def test_server_matches_packed_runner_on_card(scan_depth, cuda_device):
    """The streaming server at N = 21, L = 8192 (fused) on a capture
    rendered on the card: one launch of each fused kernel a block and no
    plain run, every frame 22 x 8192 int8, and its wire bytes bit-equal to
    the packed scan runner's on the same bytes from the same state."""
    import numpy as np

    from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
    from coherent_rtlsdr_tpu_torch.io.streamio import Capture
    from coherent_rtlsdr_tpu_torch.pipeline import init_state, make_packed_scan_runner
    from coherent_rtlsdr_tpu_torch.pipeline.state import pack_state
    from coherent_rtlsdr_tpu_torch.signal import synth_stream_slab
    from coherent_rtlsdr_tpu_torch.signal.sources import FileSource

    n, L, T = 21, 8192, 8
    truth = make_truth(n, seed=4, max_delay=40.0, snr_db=30.0)
    sig, ref = synth_stream_slab(4, truth, 0, T, block_len=L, device=cuda_device)
    assert sig.device.type == cuda_device.type and tuple(sig.shape) == (T, n, L, 2)
    seqs = np.tile(np.arange(1, T + 1, dtype=np.uint32)[:, None], (1, n))
    cap = Capture(sig_u8=sig.cpu().numpy(), ref_u8=ref.cpu().numpy(), seqnums=seqs,
                  fs=2.048e6, fcenter=1024e6)
    cfg = PipelineConfig(n_channels=n, block_len=L, fft_impl="fused", lag_method="phase_zoom")
    k = get_fused_kernels(2 * L, cuda_device)
    pub = _RecordingPublisher()
    srv = CoherentServer(cfg, FileSource(cap), publisher=pub, control=_NoControl(),
                         scan_depth=scan_depth, device=cuda_device)
    k.reset_counts()
    assert srv.run() == T
    assert k.counts() == dict.fromkeys(k.counts(), 0) | dict(
        measure_ref_launches=T, measure_spec_launches=T, apply_spec_i8_launches=T)
    run = make_packed_scan_runner(cfg)
    _, (wire, wire_ref), _ = run(pack_state(init_state(cfg, cuda_device)),
                                 sig.reshape(T, n, 2 * L), ref.reshape(T, 2 * L),
                                 torch.tensor(True, device=cuda_device),
                                 torch.from_numpy(seqs.astype(np.int64)).to(cuda_device))
    want = torch.cat([wire_ref.reshape(T, 1, L, 2), wire.reshape(T, n, L, 2)], dim=1)
    want = want.cpu().numpy()
    for t, (iq, s) in enumerate(pub.frames):
        assert iq.shape == (n + 1, L, 2) and iq.dtype == np.int8
        assert int(s[0]) == t + 1
        np.testing.assert_array_equal(iq, want[t])


@pytest.mark.cuda
def test_stream_slab_and_farrow_on_card(cuda_device):
    """A slab rendered on the card is continuous across slabs (reference
    bytes equal), and the Farrow interpolator on the card agrees with the
    CPU within 1e-5 on the same input."""
    from coherent_rtlsdr_tpu_torch.ops.delay import farrow_fractional_delay
    from coherent_rtlsdr_tpu_torch.signal import synth_stream_slab

    truth = make_truth(3, seed=7, max_delay=40.0, max_ppm=20.0)
    _, ref_a = synth_stream_slab(7, truth, 1, 4, block_len=2048, device=cuda_device)
    _, ref_big = synth_stream_slab(7, truth, 0, 8, block_len=2048, device=cuda_device)
    assert ref_a.device.type == cuda_device.type and torch.equal(ref_a, ref_big[4:])
    g = torch.Generator().manual_seed(3)
    x = torch.complex(torch.randn((3, 4096), generator=g), torch.randn((3, 4096), generator=g))
    adv = torch.linspace(-20.5, 17.25, 4096)[None] + torch.rand((3, 1), generator=g)
    got = farrow_fractional_delay(x.to(cuda_device), adv.to(cuda_device)).cpu()
    assert (got - farrow_fractional_delay(x, adv)).abs().max().item() <= 1e-5
