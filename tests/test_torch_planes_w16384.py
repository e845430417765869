"""The port's float measure / apply at the production width W = 16384
(m = 128) against the JAX package's ``FusedPipelineKernels.measure`` /
``.apply`` (Pallas, interpret mode on the CPU), on the JAX package's own
bf16 planes (``kernels/backend.py:FusedSpectral.prepare``) of the same
numpy-seeded blocks, T = 3 blocks (two windows) of N = 2 channels. On CPU
tensors the port runs its plain versions, which the CUDA kernels
fused_measure_planes / fused_apply_planes are held to on the card
(tests/test_torch_cuda.py).

Bars: those of tests/test_torch_backend.py's float kernels. Where the
channel correlates (mag >= 0.1): lag atol 1e-3 samples; |z|, sum |D|^2 and
sum |G|^2 rtol 1e-3; the same accept/reject decision everywhere. The apply
(advances of -1500.25 and 1023.5 among the windows): max |diff| <= 2/127
and under 1e-3 of the samples more than 1/127 apart, the int8 wire bars
in float units.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.kernels.backend import FusedSpectral as JaxFusedSpectral
from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels
from test_torch_backend import _assert_float_wire_close
from test_torch_fused import MIN_CORR_MAG, _stream_bytes

M = 128
W = M * M
L = W // 2
T, N = 3, 2


@pytest.fixture(scope="module")
def jax_spectral():
    return JaxFusedSpectral(W)


@pytest.fixture(scope="module", params=["random", "correlated"])
def planes(request, jax_spectral):
    """(kind, the JAX planes (pre, pim, rre, rim), the same as bf16 torch
    tensors) of numpy-seeded blocks: uniform random, or fractionally
    delayed, rotated, noisy copies of a Gaussian reference."""
    raw, ref_raw = _stream_bytes(request.param, seed=19, m=M, t=T, n_ch=N)
    c = lambda b: (b[..., 0::2] + 1j * b[..., 1::2]).astype(np.complex64) / np.float32(127)
    sig = c(raw.astype(np.float32)).reshape(T, N, L)
    ref = c(ref_raw.astype(np.float32)).reshape(T, L)
    jctx = jax_spectral.prepare(jnp.asarray(sig), jnp.asarray(ref))
    tplanes = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
               for x in jctx]
    return request.param, jctx, tplanes


def test_measure_matches_jax_at_w16384(planes, jax_spectral):
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


def test_apply_matches_jax_at_w16384(planes, jax_spectral):
    _, jctx, tplanes = planes
    rng = np.random.default_rng(20)
    adv = rng.uniform(-40, 40, (T - 1, N)).astype(np.float32)
    adv[0, 0] = -1500.25
    adv[1, 1] = 1023.5
    yj = jax.jit(jax_spectral._k.apply)(jctx.pre, jctx.pim, jnp.asarray(adv))
    k = FusedPipelineKernels(W, "cpu")
    yt = k.apply(tplanes[0], tplanes[1], torch.from_numpy(adv))
    assert k.counts() == dict.fromkeys(k.counts(), 0) | {"apply_plain_runs": 1}
    for a, b in zip(yt, yj):
        assert a.dtype == torch.float32 and tuple(a.shape) == (T - 1, N, L)
        _assert_float_wire_close(a.numpy(), b)
        # The output is not trivially small: the comparison sees real samples.
        assert np.abs(np.asarray(b)).max() >= 8 / 127
