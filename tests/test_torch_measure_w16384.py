"""The port's i8 measures at the production width W = 16384 (m = 128)
against the JAX package's ``FusedPipelineKernels`` (Pallas, interpret mode
on the CPU), on the same numpy-seeded bytes, T = 3 blocks (two windows) of
N = 2 channels. On CPU tensors the port runs its plain versions, which the
CUDA kernels are held to on the card (tests/test_torch_cuda.py).

Bars: those of tests/test_torch_fused.py (scalars where mag >= 0.1, the same
accept/reject decision, and the stored spectra D within 1 bf16 ulp but for
under 1e-3 of the elements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.kernels.pallas_fused import FusedPipelineKernels as JaxKernels
from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels
from test_torch_fused import MIN_CORR_MAG, _assert_measure_close, _stream_bytes

M = 128
W = M * M
T, N = 3, 2


@pytest.fixture(scope="module")
def jax_kernels():
    return JaxKernels(W)


@pytest.mark.parametrize("entry", ["measure_i8_spec", "measure_i8"])
@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_measure_matches_jax_at_w16384(kind, entry, jax_kernels):
    raw, ref_raw = _stream_bytes(kind, seed=16, m=M, t=T, n_ch=N)
    j = [np.asarray(x.astype(jnp.float32))
         for x in jax.jit(getattr(jax_kernels, entry))(jnp.asarray(raw), jnp.asarray(ref_raw))]
    k = FusedPipelineKernels(W, "cpu")
    t = [x.float().numpy()
         for x in getattr(k, entry)(torch.from_numpy(raw), torch.from_numpy(ref_raw))]
    plain = "measure_spec" if entry == "measure_i8_spec" else "measure_i8"
    assert k.counts() == dict.fromkeys(k.counts(), 0) | {"measure_ref_plain_runs": 1,
                                                         f"{plain}_plain_runs": 1}
    assert len(t) == len(j) == (7 if entry == "measure_i8_spec" else 5)
    assert t[0].shape == (T - 1, N)
    assert all(x.shape == (T - 1, N, M, M) for x in t[5:])
    _assert_measure_close(t, j)
    used = j[3] >= MIN_CORR_MAG
    assert used.all() if kind == "correlated" else not used.any(), j[3]
