"""The port's i8 applies at the production width W = 16384 (m = 128) against
the JAX package's ``FusedPipelineKernels`` (Pallas, interpret mode on the
CPU), on the same numpy-seeded bytes, advances and phase factors, T = 3
blocks (two windows) of N = 2 channels. On CPU tensors the port runs its
plain versions, which the CUDA kernels are held to on the card
(tests/test_torch_cuda.py).

``apply_spec_i8`` gets the JAX measure's own stored spectra D on both sides,
so the comparison holds the apply alone; ``apply_i8`` gets the bytes.

Bars: those of tests/test_torch_fused.py (wire bytes max |diff| <= 2 LSB,
under 1e-3 of them more than 1 LSB apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.kernels.pallas_fused import FusedPipelineKernels as JaxKernels
from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels
from test_torch_fused import _assert_wire_close, _stream_bytes

M = 128
W = M * M
T, N = 3, 2


@pytest.fixture(scope="module")
def jax_kernels():
    return JaxKernels(W)


def _apply_args(seed):
    """Advances with a large negative and a fractional one among the windows,
    and unit phase factors, float32 [T-1, N]."""
    rng = np.random.default_rng(seed)
    adv = rng.uniform(-40, 40, (T - 1, N)).astype(np.float32)
    adv[0, 0] = -1500.25
    adv[1, 1] = 1023.5
    ph = np.exp(1j * rng.uniform(-np.pi, np.pi, (T - 1, N)))
    return adv, ph.real.astype(np.float32), ph.imag.astype(np.float32)


@pytest.mark.parametrize("entry", ["apply_spec_i8", "apply_i8"])
@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_apply_matches_jax_at_w16384(kind, entry, jax_kernels):
    raw, ref_raw = _stream_bytes(kind, seed=17, m=M, t=T, n_ch=N)
    args = _apply_args(18)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    k = FusedPipelineKernels(W, "cpu")
    if entry == "apply_spec_i8":
        jd = jax.jit(jax_kernels.measure_i8_spec)(jnp.asarray(raw), jnp.asarray(ref_raw))[5:]
        wj = jax.jit(jax_kernels.apply_spec_i8)(*jd, *jargs)
        d = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in jd]
        wt = k.apply_spec_i8(*d, *targs)
    else:
        wj = jax.jit(jax_kernels.apply_i8)(jnp.asarray(raw), *jargs)
        wt = k.apply_i8(torch.from_numpy(raw), *targs)
    assert k.counts() == dict.fromkeys(k.counts(), 0) | {f"{entry}_plain_runs": 1}
    assert wt.dtype == torch.int8 and tuple(wt.shape) == (T - 1, N, M // 2, 2 * M)
    _assert_wire_close(wt.numpy(), np.asarray(wj))
    # The output is not trivially small: the comparison sees real bytes.
    assert np.abs(np.asarray(wj, np.int32)).max() >= 8
