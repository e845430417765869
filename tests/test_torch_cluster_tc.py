"""The m = 256 cluster kernels' table path, checked on the CPU.

At W = 65536 (m = 256) every kernel streams F or Fi through shared memory
as the packed bf16 k-slices of ``kernels/fused.py:cluster_slices`` (the
table ring of ``csrc/fused_cluster.cuh``): slice s holds the rows n and the
columns k in [16 s, 16 s + 16) of each (re, im) plane in 8 x 8 core
matrices, (n // 8, k % 16 // 8) in that order. Each product takes its
table operand from the slices as B (stored [n][k]; F and Fi are symmetric),
one k step of 16 a slice, each complex product as four real bf16 products
with float32 sums (re = Ar Br - Ai Bi, im = Ar Bi + Ai Br), and runs transposed
where that keeps the table as B: the forward's first product as B^T = A^T F
(C^T = bf16(B^T * T^T), T symmetric), its second as D = C F; the inverse's
first as C2 = G Fi, B2 = bf16(C2 * conj(T)), its second as y^T = B2^T Fi.

The table tests check what the wrappers hand the kernels: the slices
unpack bit for bit to ``FFT4Step``'s bf16-rounded F / Fi and to the JAX
``FFT4StepPallas`` tables after a bf16 cast, and each element sits at the
offset the kernel reads. The decomposition tests check the design, not the
CUDA kernel (which only the card runs: tests/test_torch_cuda.py's m = 256
cases, chip_smoke.py phases 19 and 20): the products written here in plain
PyTorch from the slices, their operands assembled slice by slice along k,
in the kernels' orientations, are held to

  * the bf16 ``FFT4Step`` (the kernels' plain version) within 1e-6 of
    max |plain| (the same bf16 roundings; only float32 summation order can
    differ: a sum taken a slice at a time instead moves a bf16 rounding of
    the intermediate now and then, 1.6e-4 of max |plain| here, which the
    card tests' bars cover);
  * the JAX ``FFT4StepPallas`` in interpret mode within 1e-3 of its
    max |value| (the four-step tolerance of tests/test_torch_spectral.py),

forward and inverse at W = 65536.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.kernels.pallas_fft import FFT4StepPallas
from coherent_rtlsdr_tpu_torch.kernels import fused_cuda
from coherent_rtlsdr_tpu_torch.kernels.fourstep import FFT4StepKernel
from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels

M = 256
W = M * M
K = 16
DIRECTIONS = ["forward", "inverse"]
PLAIN_REL = 1e-6
PALLAS_REL = 1e-3
BATCH = 2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _slice_planes(sl: torch.Tensor, s: int):
    """Slice s of a packed table as float32 (re, im) [m (n), 16 (k)]."""
    x = sl[s].float()                                   # [2, m/8, 2, 8, 8]: pl, G, h, n8, k8
    x = x.permute(0, 1, 3, 2, 4).reshape(2, M, K)       # pl, (G, n8), (h, k8)
    return x[0], x[1]


def _unpack(sl: torch.Tensor) -> torch.Tensor:
    """The bf16 ``[2, m, m]`` (re, im) planes of a packed table."""
    return sl.permute(1, 2, 4, 0, 3, 5).reshape(2, M, M)


def _sliced_product(are, aim, sl):
    """(are + i aim) @ T^T, T the packed table (the products' B operand,
    stored [n][k]) assembled from its k slices in slice order, as four real
    products (re = Ar Br - Ai Bi, im = Ar Bi + Ai Br) of float32 matrices
    holding bf16 values."""
    planes = [_slice_planes(sl, s) for s in range(M // K)]
    bre = torch.cat([p[0] for p in planes], dim=-1)
    bim = torch.cat([p[1] for p in planes], dim=-1)
    return are @ bre.T - aim @ bim.T, are @ bim.T + aim @ bre.T


def cluster_forward(x, f_sl, tw):
    """x ``[B, m*m]`` -> the permuted spectrum D ``[B, m (k2), m (k1)]`` as
    the forward cluster kernels compute it."""
    A = x.reshape(-1, M, M)                                          # [n2][n1]
    at_re, at_im = _bf16(A.real).transpose(-1, -2), _bf16(A.imag).transpose(-1, -2)
    bt_re, bt_im = _sliced_product(at_re, at_im, f_sl)               # B^T [n1][k2]
    tre, tim = tw[..., 0], tw[..., 1]                                # T^T = T, [n1][k2]
    ct_re = _bf16(bt_re * tre - bt_im * tim)
    ct_im = _bf16(bt_re * tim + bt_im * tre)
    return torch.complex(*_sliced_product(ct_re.transpose(-1, -2), ct_im.transpose(-1, -2),
                                          f_sl))


def cluster_inverse(X, fi_sl, tw):
    """The permuted spectrum ``[B, m, m]`` -> time ``[B, m*m]`` as the
    inverse cluster kernels compute it."""
    c_re, c_im = _sliced_product(_bf16(X.real), _bf16(X.imag), fi_sl)   # C2 [k2][n1]
    tre, tim = tw[..., 0], tw[..., 1]
    b_re = _bf16(c_re * tre + c_im * tim)
    b_im = _bf16(c_im * tre - c_re * tim)
    yt_re, yt_im = _sliced_product(b_re.transpose(-1, -2), b_im.transpose(-1, -2), fi_sl)
    return torch.complex(yt_re, yt_im).transpose(-1, -2).reshape(-1, W)   # y [n2][n1]


def _signal(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((BATCH, W)) + 1j * rng.standard_normal((BATCH, W))) * 0.3
            ).astype(np.complex64)


def _tables(k: FFT4StepKernel, direction: str):
    return k.f_packed if direction == "forward" else k.fi_packed


@pytest.mark.parametrize("owner", ["fourstep", "fused"])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_slices_unpack_to_the_bf16_tables(direction, owner):
    """Both kernel objects hold the same slices, which are F / Fi as
    FFT4Step rounds them and as the JAX kernel casts them, bit for bit."""
    if owner == "fourstep":
        k = FFT4StepKernel(W, "cpu")
        sl, plain = _tables(k, direction), k.plain
    else:
        k = FusedPipelineKernels(W, "cpu")
        sl, plain = (k.f_slices if direction == "forward" else k.fi_slices), k.fft
    assert sl.dtype == torch.bfloat16 and tuple(sl.shape) == fused_cuda.SLICES_SHAPE
    assert sl.is_contiguous()
    want = (plain.fre, plain.fim) if direction == "forward" else (plain.fire, plain.fiim)
    jp = FFT4StepPallas(W)
    jax_tables = jp._fwd_tables if direction == "forward" else jp._inv_tables
    for plane, w, jt in zip(_unpack(sl), want, jax_tables[:2]):
        assert torch.equal(plane.float(), w)
        jax_bf16 = np.asarray(jnp.asarray(jt).astype(jnp.bfloat16)).view(np.int16)
        np.testing.assert_array_equal(plane.contiguous().view(torch.int16).numpy(), jax_bf16)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_slices_hold_each_element_where_the_kernel_reads_it(direction):
    """Element (n, k) of plane pl sits in slice k // 16 at element offset
    pl * 4096 + (2 (n // 8) + k % 16 // 8) * 64 + (n % 8) * 8 + k % 8
    (the K-major, unswizzled layout of csrc/fused_cluster.cuh's
    slice_product descriptors: each core matrix 128 contiguous bytes, the
    next 8 k 128 bytes on, the next 8 rows 256)."""
    k = FFT4StepKernel(W, "cpu")
    flat = _tables(k, direction).reshape(M // K, -1)
    want = ((k.plain.fre, k.plain.fim) if direction == "forward"
            else (k.plain.fire, k.plain.fiim))
    rng = np.random.default_rng(15)
    for n, kk in rng.integers(0, M, (64, 2)):
        for pl in range(2):
            off = pl * M * K + (2 * (n // 8) + (kk % K) // 8) * 64 + (n % 8) * 8 + kk % 8
            assert flat[kk // K, off].float() == want[pl][n, kk]


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_sliced_decomposition_matches_plain_version(direction):
    k = FFT4StepKernel(W, "cpu")
    tw = fused_cuda._tables(k.plain)[2]
    x = torch.from_numpy(_signal(81))
    if direction == "forward":
        got, want = cluster_forward(x, k.f_packed, tw), k.fft_plain(x)
    else:
        X = k.fft_plain(x)
        got, want = cluster_inverse(X, k.fi_packed, tw), k.ifft_plain(X)
    assert got.shape == want.shape
    assert ((got - want).abs().max() / want.abs().max()).item() <= PLAIN_REL


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_sliced_decomposition_matches_pallas_interpret(direction):
    k = FFT4StepKernel(W, "cpu")
    tw = fused_cuda._tables(k.plain)[2]
    jp = FFT4StepPallas(W, interpret=True)
    x = _signal(82)
    if direction == "forward":
        got = cluster_forward(torch.from_numpy(x), k.f_packed, tw).numpy()
        want = np.asarray(jp.fft(jnp.asarray(x)))
    else:
        X = np.array(jp.fft(jnp.asarray(x)))
        got = cluster_inverse(torch.from_numpy(X), k.fi_packed, tw).numpy()
        want = np.asarray(jp.ifft(jnp.asarray(X)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < PALLAS_REL
