"""The tensor-core four-step kernel's tables and decomposition, checked on
the CPU.

``csrc/fourstep.cu`` runs each complex product as four real bf16-operand
products accumulated in float32 (re = Ar Br + (-Ai) Bi, im = Ar Bi + Ai Br)
from the packed bf16 tables of ``kernels/fourstep.py:packed_tables``, and
runs the inverse transposed (C^T = Fi G^T, B^T = bf16(C^T conj T),
x^T = B^T Fi), which the symmetry of F, Fi and T allows.

The table tests check what the wrapper hands the kernel. The decomposition
tests check the design, not the CUDA kernel (which only the card runs, in
tests/test_torch_cuda.py and chip_smoke.py): the same decomposition, written
here in plain PyTorch from the packed tables and the kernel's twiddle, is
held to:

  * the bf16 ``FFT4Step`` (the kernel's plain version) within 1e-6 of
    max |plain| (the same bf16 roundings; only float32 summation order can
    differ);
  * the JAX ``FFT4StepPallas`` in interpret mode within 1e-3 of its
    max |value| (the four-step tolerance of tests/test_torch_spectral.py).

The packed tables equal ``FFT4Step``'s bf16-rounded F / Fi and the JAX
kernel's tables after a bf16 cast, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.kernels.pallas_fft import FFT4StepPallas
from coherent_rtlsdr_tpu_torch.kernels import fused_cuda
from coherent_rtlsdr_tpu_torch.kernels.fourstep import FFT4StepKernel

SIZES = [4096, 16384]
DIRECTIONS = ["forward", "inverse"]
PLAIN_REL = 1e-6
PALLAS_REL = 1e-3
BATCH = 3


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _twiddle(k: FFT4StepKernel) -> torch.Tensor:
    """The float32 twiddle [m, m, 2] the wrapper hands the kernel."""
    return fused_cuda._tables(k.plain)[2]


def _real_products(are, aim, bre, bim):
    """(are + i aim) @ (bre + i bim) as four real products of bf16-valued
    float32 operands: re = ar br + (-ai) bi, im = ar bi + ai br."""
    return are @ bre + (-aim) @ bim, are @ bim + aim @ bre


def tc_forward(x: torch.Tensor, f: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The kernel's forward: x ``[B, m*m]`` -> permuted spectrum ``[B, m, m]``."""
    m = f.shape[-1]
    fre, fim = f.float()
    A = x.reshape(-1, m, m)
    bre, bim = _real_products(fre, fim, _bf16(A.real), _bf16(A.imag))
    tre, tim = tw[..., 0], tw[..., 1]
    cre = bre * tre - bim * tim
    cim = bre * tim + bim * tre
    return torch.complex(*_real_products(_bf16(cre), _bf16(cim), fre, fim))


def tc_inverse(X: torch.Tensor, fi: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The kernel's inverse, transposed: X ``[B, m, m]`` -> time ``[B, m*m]``."""
    m = fi.shape[-1]
    fre, fim = fi.float()
    gt_re = _bf16(X.real).transpose(-1, -2)
    gt_im = _bf16(X.imag).transpose(-1, -2)
    ct_re, ct_im = _real_products(fre, fim, gt_re, gt_im)
    tre, tim = tw[..., 0], tw[..., 1]
    bt_re = ct_re * tre + ct_im * tim
    bt_im = ct_im * tre - ct_re * tim
    xt_re, xt_im = _real_products(_bf16(bt_re), _bf16(bt_im), fre, fim)
    return torch.complex(xt_re, xt_im).transpose(-1, -2).reshape(-1, m * m)


def _signal(W: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, W))
            + 1j * rng.standard_normal((BATCH, W))).astype(np.complex64)


def _inputs(W: int, direction: str):
    """The kernel instance and a forward input (time) or an inverse input
    (a permuted spectrum of the plain forward), complex64."""
    k = FFT4StepKernel(W, "cpu")
    x = torch.from_numpy(_signal(W, W + len(direction)))
    return k, (x if direction == "forward" else k.plain.fft(x))


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("W", SIZES)
def test_packed_tables_equal_the_bf16_tables(W, direction):
    k = FFT4StepKernel(W, "cpu")
    m = k.m
    packed = k.f_packed if direction == "forward" else k.fi_packed
    plain = ((k.plain.fre, k.plain.fim) if direction == "forward"
             else (k.plain.fire, k.plain.fiim))
    jp = FFT4StepPallas(W)
    jax_tables = jp._fwd_tables if direction == "forward" else jp._inv_tables
    assert packed.dtype == torch.bfloat16 and tuple(packed.shape) == (2, m, m)
    assert packed.is_contiguous()
    for plane, want, jt in zip(packed, plain, jax_tables[:2]):
        assert torch.equal(plane.float(), want)
        jax_bf16 = np.asarray(jnp.asarray(jt).astype(jnp.bfloat16)).view(np.int16)
        np.testing.assert_array_equal(plane.view(torch.int16).numpy(), jax_bf16)
    tw = _twiddle(k).numpy()
    np.testing.assert_array_equal(tw[..., 0], np.asarray(jp._fwd_tables[2]))
    np.testing.assert_array_equal(tw[..., 1], np.asarray(jp._fwd_tables[3]))


@pytest.mark.parametrize("W", SIZES)
def test_tables_are_symmetric(W):
    """The kernel reads F, Fi and T as stored [n][k] where the products want
    [k][n], and runs the inverse transposed: both rest on symmetry."""
    k = FFT4StepKernel(W, "cpu")
    for t in (k.f_packed, k.fi_packed):
        assert torch.equal(t, t.transpose(-1, -2))
    assert torch.equal(_twiddle(k), _twiddle(k).transpose(0, 1))


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("W", SIZES)
def test_decomposition_matches_plain_version(W, direction):
    k, x = _inputs(W, direction)
    if direction == "forward":
        got, want = tc_forward(x, k.f_packed, _twiddle(k)), k.plain.fft(x)
    else:
        got, want = tc_inverse(x, k.fi_packed, _twiddle(k)), k.plain.ifft(x)
    assert got.shape == want.shape
    assert ((got - want).abs().max() / want.abs().max()).item() <= PLAIN_REL


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("W", SIZES)
def test_decomposition_matches_pallas_interpret(W, direction):
    k, x = _inputs(W, direction)
    jp = FFT4StepPallas(W, interpret=True)
    xj = jnp.asarray(x.numpy())
    if direction == "forward":
        got, want = tc_forward(x, k.f_packed, _twiddle(k)).numpy(), np.asarray(jp.fft(xj))
    else:
        got, want = tc_inverse(x, k.fi_packed, _twiddle(k)).numpy(), np.asarray(jp.ifft(xj))
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < PALLAS_REL
