"""Kernel table rows 4-7 at W = 65536 (m = 256, L = 32768) against the JAX
package, on the same numpy-seeded inputs: the recompute apply
(``apply_i8``), the four-step FFT (``FFT4StepKernel``), the float measure
and apply (``measure`` / ``apply`` on the JAX package's own bf16 planes),
and the generic offline engine (``fft_impl="pallas"``). The JAX package
runs its Pallas kernels in interpret mode on the CPU; on CPU tensors the
port runs its plain versions, which the CUDA kernels (a window, or a
transform, a cluster of four CTAs at this size) are held to on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 20).

Bars, and why:
  * ``apply_i8`` (T = 3 blocks of N = 2 channels, advances -1500.25 and
    1023.5 among the windows): wire bytes max |diff| <= 2 LSB with under
    1e-3 of them > 1 LSB (tests/test_torch_recompute.py, the reference's
    own bars, tests/test_kernels.py:443-450);
  * the four-step (B = 2): within 1e-3 of the JAX output's largest element
    (tests/test_torch_fourstep_tc.py: the same bf16 roundings, float32 sums
    in another order); the cluster kernel's decomposition (strips and row
    blocks of 64, on F and Fi as float32 pairs; the packed k-slices the
    kernel streams are held in tests/test_torch_cluster_tc.py) within 1e-6
    of the plain version, in its output order;
  * ``measure`` / ``apply`` (T = 3, N = 2): tests/test_torch_planes_w16384.py's
    bars, where the channel correlates (mag >= 0.1) lag atol 1e-3 samples,
    |z|, sum |D|^2 and sum |G|^2 rtol 1e-3, the same accept/reject decision
    everywhere; the apply within 2/127 with under 1e-3 of the samples more
    than 1/127 apart;
  * ``align_offline(fft_impl="pallas", lag_method="phase_slope")`` (3
    channels, 5 blocks, global and ema): tests/test_torch_generic.py's bars,
    delay and lag atol 2e-3 samples, mag rtol 1e-3, phase atol 1e-3, the
    aligned samples as int8 within the wire bars, the reference equal;
  * the cost model: the four bounds at chip_smoke.py phase 20's shapes
    (N = 21, T = 64, 1,323 windows) to 0.01 ms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu import pipeline as jpipe
from coherent_rtlsdr_tpu.kernels.backend import FusedSpectral as JaxFusedSpectral
from coherent_rtlsdr_tpu.kernels.pallas_fft import FFT4StepPallas
from coherent_rtlsdr_tpu.kernels.pallas_fused import FusedPipelineKernels as JaxKernels
from coherent_rtlsdr_tpu.signal import make_truth as jax_make_truth
from coherent_rtlsdr_tpu.signal import synth_capture as jax_synth_capture
from coherent_rtlsdr_tpu_torch.kernels import fused_cuda
from coherent_rtlsdr_tpu_torch.kernels.fourstep import FFT4StepKernel
from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels
from coherent_rtlsdr_tpu_torch.ops.convert import c64_to_i8_iq
from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig, align_offline
from coherent_rtlsdr_tpu_torch.tools import cost_model
from test_torch_backend import _assert_float_wire_close
from test_torch_fused import MIN_CORR_MAG, _stream_bytes
from test_torch_generic import _assert_wire_close, _wire

M = 256
W = M * M
L = W // 2
T, N = 3, 2
GENERIC = dict(fft_impl="pallas", lag_method="phase_slope")


def _advances(seed):
    """Advances in [-40, 40) with a large negative and a fractional one
    among the windows, and unit phase factors (re, im), float32 [T-1, N]."""
    rng = np.random.default_rng(seed)
    adv = rng.uniform(-40, 40, (T - 1, N)).astype(np.float32)
    adv[0, 0] = -1500.25
    adv[1, 1] = 1023.5
    ph = np.exp(1j * rng.uniform(-np.pi, np.pi, (T - 1, N)))
    return adv, ph.real.astype(np.float32), ph.imag.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_apply_i8_matches_jax_at_w65536(kind):
    raw, _ = _stream_bytes(kind, seed=68, m=M, t=T, n_ch=N)
    args = _advances(69)
    wj = np.asarray(jax.jit(JaxKernels(W).apply_i8)(jnp.asarray(raw),
                                                     *(jnp.asarray(a) for a in args)))
    k = FusedPipelineKernels(W, "cpu")
    wt = k.apply_i8(torch.from_numpy(raw), *(torch.from_numpy(a) for a in args))
    assert k.counts() == dict.fromkeys(k.counts(), 0) | {"apply_i8_plain_runs": 1}
    assert wt.dtype == torch.int8 and tuple(wt.shape) == (T - 1, N, M // 2, 2 * M)
    _assert_wire_close(wt.numpy(), wj)
    assert np.abs(wj.astype(np.int32)).max() >= 8


def _signal(seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((2, W)) + 1j * rng.standard_normal((2, W))) * 0.3
            ).astype(np.complex64)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_fourstep_matches_jax_at_w65536(direction):
    x = _signal(70)
    jp = FFT4StepPallas(W)
    k = FFT4StepKernel(W, "cpu")
    if direction == "forward":
        want = np.asarray(jp.fft(jnp.asarray(x)))
        got = k.fft(torch.from_numpy(x)).numpy()
        assert got.shape == (2, M, M)
    else:
        X = np.array(jp.fft(jnp.asarray(x)))
        want = np.asarray(jp.ifft(jnp.asarray(X)))
        got = k.ifft(torch.from_numpy(X)).numpy()
        assert got.shape == (2, W)
    assert k.counts() == dict(fft_launches=0, ifft_launches=0,
                              fft_plain_runs=int(direction == "forward"),
                              ifft_plain_runs=int(direction == "inverse"))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-3


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _cmm(are, aim, bre, bim):
    return are @ bre - aim @ bim, are @ bim + aim @ bre


def cluster_forward(x, F, Tw):
    """csrc/fourstep.cu:fourstep_cluster_kernel<false> in plain PyTorch, as
    its four CTAs cut the work: strip q (columns [64 q, 64 q + 64)) of C =
    bf16((F A) * T), then row block p of D = C F, written at rows
    [64 p, 64 p + 64) of the permuted spectrum."""
    P = M // 4
    A = x.reshape(-1, M, M)
    are, aim = _bf16(A.real), _bf16(A.imag)
    strips = []
    for q in range(4):
        s = slice(P * q, P * q + P)
        bre, bim = _cmm(F[..., 0], F[..., 1], are[..., s], aim[..., s])
        tre, tim = Tw[:, s, 0], Tw[:, s, 1]
        strips.append((_bf16(bre * tre - bim * tim), _bf16(bre * tim + bim * tre)))
    D = torch.empty(A.shape, dtype=torch.complex64)
    for p in range(4):
        rows = slice(P * p, P * p + P)
        cre = torch.cat([st[0][:, rows] for st in strips], dim=-1)
        cim = torch.cat([st[1][:, rows] for st in strips], dim=-1)
        D[:, rows] = torch.complex(*_cmm(cre, cim, F[..., 0], F[..., 1]))
    return D


def cluster_inverse(X, Fi, Tw):
    """fourstep_cluster_kernel<true>: row block p of B2 = bf16((bf16(X) Fi)
    * conj(T)), then strip q of x = Fi B2 over all m rows, written at
    columns n1 in [64 q, 64 q + 64) of rows n2, natural order x[n2 m + n1]."""
    P = M // 4
    blocks = []
    for p in range(4):
        rows = slice(P * p, P * p + P)
        cre, cim = _cmm(_bf16(X.real[:, rows]), _bf16(X.imag[:, rows]), Fi[..., 0], Fi[..., 1])
        tre, tim = Tw[rows, :, 0], Tw[rows, :, 1]
        blocks.append((_bf16(cre * tre + cim * tim), _bf16(cim * tre - cre * tim)))
    y = torch.empty(X.shape, dtype=torch.complex64)
    for q in range(4):
        s = slice(P * q, P * q + P)
        bre = torch.cat([b[0][..., s] for b in blocks], dim=-2)
        bim = torch.cat([b[1][..., s] for b in blocks], dim=-2)
        y[..., s] = torch.complex(*_cmm(Fi[..., 0], Fi[..., 1], bre, bim))
    return y.reshape(-1, W)


def test_fourstep_cluster_decomposition_matches_plain():
    """The m = 256 kernel's cut into strips and row blocks, on F, Fi and
    the twiddle as float32 pairs (``fused_cuda._tables``), equals the plain
    version in value and in its output order."""
    k = FFT4StepKernel(W, "cpu")
    F, Fi, Tw = fused_cuda._tables(k.plain)
    x = torch.from_numpy(_signal(71))
    want = k.fft_plain(x)
    got = cluster_forward(x, F, Tw)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-6
    back = k.ifft_plain(want)
    got = cluster_inverse(want, Fi, Tw)
    assert got.shape == back.shape == (2, W)
    assert ((got - back).abs().max() / back.abs().max()).item() <= 1e-6


@pytest.fixture(scope="module")
def jax_spectral():
    return JaxFusedSpectral(W)


@pytest.fixture(scope="module", params=["random", "correlated"])
def planes(request, jax_spectral):
    """(kind, the JAX planes (pre, pim, rre, rim), the same as bf16 torch
    tensors) of numpy-seeded blocks: uniform random, or fractionally
    delayed, rotated, noisy copies of a Gaussian reference."""
    raw, ref_raw = _stream_bytes(request.param, seed=72, m=M, t=T, n_ch=N)
    c = lambda b: (b[..., 0::2] + 1j * b[..., 1::2]).astype(np.complex64) / np.float32(127)
    sig = c(raw.astype(np.float32)).reshape(T, N, L)
    ref = c(ref_raw.astype(np.float32)).reshape(T, L)
    jctx = jax_spectral.prepare(jnp.asarray(sig), jnp.asarray(ref))
    tplanes = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
               for x in jctx]
    return request.param, jctx, tplanes


def test_measure_planes_matches_jax_at_w65536(planes, jax_spectral):
    kind, jctx, tplanes = planes
    want = [np.asarray(x) for x in jax.jit(jax_spectral._k.measure)(*jctx)]
    k = FusedPipelineKernels(W, "cpu")
    got = [x.numpy() for x in k.measure(*tplanes)]
    assert k.counts() == dict.fromkeys(k.counts(), 0) | {"measure_plain_runs": 1}
    for x in got:
        assert x.shape == (T - 1, N) and np.isfinite(x).all()
    rre, rim = (x.float().numpy() for x in tplanes[2:])
    eref = (rre * rre + rim * rim).sum((-2, -1))[:, None]
    mag = lambda out: out[1] / np.sqrt(out[2] * eref)
    used = mag(want) >= MIN_CORR_MAG
    np.testing.assert_array_equal(mag(got) >= MIN_CORR_MAG, used)
    assert used.all() if kind == "correlated" else not used.any(), mag(want)
    np.testing.assert_allclose(got[0][used], want[0][used], atol=1e-3)
    for name, a, b in zip(("|z|", "sum|D|^2", "sum|G|^2"), got[1:], want[1:]):
        np.testing.assert_allclose(a[used], b[used], rtol=1e-3, err_msg=name)


def test_apply_planes_matches_jax_at_w65536(planes, jax_spectral):
    _, jctx, tplanes = planes
    adv = _advances(73)[0]
    yj = jax.jit(jax_spectral._k.apply)(jctx.pre, jctx.pim, jnp.asarray(adv))
    k = FusedPipelineKernels(W, "cpu")
    yt = k.apply(tplanes[0], tplanes[1], torch.from_numpy(adv))
    assert k.counts() == dict.fromkeys(k.counts(), 0) | {"apply_plain_runs": 1}
    for a, b in zip(yt, yj):
        assert a.dtype == torch.float32 and tuple(a.shape) == (T - 1, N, L)
        _assert_float_wire_close(a.numpy(), b)
        assert np.abs(np.asarray(b)).max() >= 8 / 127


@pytest.mark.parametrize("smoothing", ["global", "ema"])
def test_generic_align_offline_matches_jax_at_l32768(smoothing):
    truth = jax_make_truth(3, seed=74, max_delay=30.0, snr_db=30.0)
    cap = jax_synth_capture(jax.random.PRNGKey(74), truth, n_blocks=5, block_len=L)
    sig, ref = np.array(cap.sig_u8), np.array(cap.ref_u8)
    jcfg = jpipe.PipelineConfig(n_channels=3, block_len=L, **GENERIC)
    jr = jax.jit(lambda s, r: jpipe.align_offline(jcfg, s, r, smoothing=smoothing))(
        jnp.asarray(sig), jnp.asarray(ref))
    cfg = PipelineConfig(n_channels=3, block_len=L, **GENERIC)
    tr = align_offline(cfg, torch.from_numpy(sig), torch.from_numpy(ref), smoothing=smoothing)
    np.testing.assert_allclose(tr.delay.numpy(), np.asarray(jr.delay), atol=2e-3)
    np.testing.assert_allclose(tr.lag.numpy(), np.asarray(jr.lag), atol=2e-3)
    np.testing.assert_allclose(tr.mag.numpy(), np.asarray(jr.mag), rtol=1e-3)
    np.testing.assert_allclose(tr.phase.numpy(), np.asarray(jr.phase), atol=1e-3)
    assert tr.wire is None and tuple(tr.aligned.shape) == (4, 3, L)
    _assert_wire_close(c64_to_i8_iq(tr.aligned).numpy(), _wire(jr.aligned))
    np.testing.assert_array_equal(tr.ref.numpy(), np.asarray(jr.ref))
    if smoothing == "global":   # the truth delays are recovered at this length
        np.testing.assert_allclose(tr.delay.numpy()[0], truth.delays, atol=0.1)


def test_cost_model_rows_4_to_7_at_m256():
    """The bounds of rows 4-7 at chip_smoke.py phase 20's shapes (N = 21,
    L = 32768, T = 64: 1,323 windows, the four-step at B = 1,323): the
    recompute apply and the float apply a forward transform and the
    centre-row inverse (28 m^3 a window), the float measure a forward
    (16 m^3), all three bound by operations; the four-step by its bytes,
    1.39 GB in and out."""
    T64, N21 = 64, 21
    nwin = (T64 - 1) * N21
    want = {"apply_i8": (cost_model.apply_i8(T64, N21, M), 0.63, "operations"),
            "fourstep": (cost_model.fourstep(nwin, M), 0.41, "bytes"),
            "measure_planes": (cost_model.measure_planes(T64, N21, M), 0.36, "operations"),
            "apply_planes": (cost_model.apply_planes(T64, N21, M), 0.63, "operations")}
    for name, (cost, ms, by) in want.items():
        got_ms, got_by = cost_model.bound(cost)
        assert got_by == by and abs(got_ms - ms) < 0.01, (name, got_ms, got_by)
    assert cost_model.fourstep(nwin, M).bytes == 2 * nwin * W * 8
    assert cost_model.apply_i8(T64, N21, M).ops == nwin * 28 * M ** 3
