"""Bytes and matrix operations of the port's kernels, from their shapes.

For each CUDA kernel, the bytes the function must move (each input read
once, each output written once) and the operations of its matrix products:
8 m^3 for a complex m x m by m x m product (four real products of m^3
multiply-adds). A forward four-step transform is two such products (16 m^3),
the apply's inverse over the centre rows one and a half (12 m^3). ``bound``
turns a cost into the least time the card could take for it: the larger of
the bytes over the HBM rate and the operations over the dense bf16
tensor-core peak (the products take bf16 operands).

Shapes: T blocks of W = m*m int8 bytes (L = W/2 complex samples) per
channel, N channels; the i8 kernels see T - 1 overlap-save windows a channel.

``fused_cost_model`` is the per-sample counterpart of the JAX package's
``bench.py:fused_cost_model``, for either i8 pair. It counts the port's own
work, which differs from the JAX model in four ways:

* no 0/1 selection matmuls (de-interleave, re-interleave, band sums): the
  port's kernels index instead, so only the transforms count;
* the reference transform once a window (``fused_measure_ref``), where the
  JAX kernels recomputed it once a grid step of nc channels;
* the least bytes of each function, inputs read once, where the JAX model
  counted each raw block twice (as the top and the bottom of a window); the
  port also writes the reference spectra (float32) once and reads them back;
* no eager XOR pass: the pairs are timed on signed int8 blocks.
"""

from typing import NamedTuple

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 FLOP/s.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12


class Cost(NamedTuple):
    bytes: int
    ops: int

    def __add__(self, other):
        return Cost(self.bytes + other.bytes, self.ops + other.ops)


def bound(cost: Cost):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the bf16 peak, and which of the two it is."""
    t_bytes = cost.bytes / HBM_BYTES_S * 1e3
    t_ops = cost.ops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _transform_ops(m: int) -> int:
    """One forward four-step transform: two complex products."""
    return 16 * m ** 3


def measure_ref(T: int, m: int) -> Cost:
    """``fused_measure_ref``: int8 reference blocks [T, m/2, 2m] in; the
    window spectra R (float32 pairs) and energies out."""
    W = m * m
    return Cost(T * W + (T - 1) * (W * 8 + 4), (T - 1) * _transform_ops(m))


def _measure_channels(T: int, N: int, m: int, store_d: bool) -> Cost:
    W, nwin = m * m, (T - 1) * N
    nbytes = T * N * W + (T - 1) * (W * 8 + 4) + 5 * nwin * 4
    if store_d:
        nbytes += 2 * nwin * W * 2
    return Cost(nbytes, nwin * _transform_ops(m))


def measure_i8_spec(T: int, N: int, m: int) -> Cost:
    """``fused_measure_i8_spec``: int8 blocks, R and its energies in; five
    float32 scalars a window and D as bf16 (re, im) out."""
    return _measure_channels(T, N, m, store_d=True)


def measure_i8(T: int, N: int, m: int) -> Cost:
    """``fused_measure_i8``: as ``measure_i8_spec`` with no D stored."""
    return _measure_channels(T, N, m, store_d=False)


def apply_spec_i8(T: int, N: int, m: int) -> Cost:
    """``fused_apply_spec_i8``: D bf16 and three float32 scalars a window in,
    int8 wire blocks out; the inverse's centre rows."""
    W, nwin = m * m, (T - 1) * N
    return Cost(2 * nwin * W * 2 + 3 * nwin * 4 + nwin * W, nwin * 12 * m ** 3)


def apply_i8(T: int, N: int, m: int) -> Cost:
    """``fused_apply_i8``: int8 blocks and three float32 scalars a window in,
    int8 wire blocks out; the forward transform and the inverse's centre
    rows."""
    W, nwin = m * m, (T - 1) * N
    return Cost(T * N * W + 3 * nwin * 4 + nwin * W, nwin * (_transform_ops(m) + 12 * m ** 3))


def fourstep(B: int, m: int) -> Cost:
    """``fourstep_fft``: B complex64 transforms of W points in and out."""
    return Cost(2 * B * m * m * 8, B * _transform_ops(m))


def measure_planes(T: int, N: int, m: int) -> Cost:
    """``fused_measure_planes``: bf16 block planes [T, N, m/2, m] (re, im)
    and bf16 reference spectra in, four float32 scalars a window out."""
    W, nwin = m * m, (T - 1) * N
    return Cost(2 * T * N * (W // 2) * 2 + 2 * (T - 1) * W * 2 + 4 * nwin * 4,
                nwin * _transform_ops(m))


def apply_planes(T: int, N: int, m: int) -> Cost:
    """``fused_apply_planes``: bf16 block planes and the advance in, the
    float32 centre half (re, im) out; forward and centre-row inverse."""
    W, nwin = m * m, (T - 1) * N
    return Cost(2 * T * N * (W // 2) * 2 + nwin * 4 + 2 * nwin * (W // 2) * 4,
                nwin * (_transform_ops(m) + 12 * m ** 3))


def copy_blocks(T: int, N: int, m: int) -> Cost:
    """``probe_copy_blocks``: int8 [T, N, m/2, 2m] read and written."""
    return Cost(2 * T * N * m * m, 0)


def pair_cost(pair: str, T: int, N: int, m: int) -> Cost:
    """The kernels of one i8 pair on T blocks: "handoff" (``measure_ref``,
    ``measure_i8_spec``, ``apply_spec_i8``) or "recompute" (``measure_ref``,
    ``measure_i8``, ``apply_i8``)."""
    if pair == "handoff":
        return measure_ref(T, m) + measure_i8_spec(T, N, m) + apply_spec_i8(T, N, m)
    if pair == "recompute":
        return measure_ref(T, m) + measure_i8(T, N, m) + apply_i8(T, N, m)
    raise ValueError(f"pair must be 'handoff' or 'recompute', got {pair!r}")


def fused_cost_model(n_ch: int = 21, block_len: int = 8192, n_blocks: int = 256,
                     pair: str = "handoff"):
    """(bytes, operations) per output sample of one i8 pair on ``n_blocks``
    blocks of ``n_ch`` channels, counting (n_blocks - 1) * n_ch * block_len
    output samples."""
    m = round((2 * block_len) ** 0.5)
    if m * m != 2 * block_len:
        raise ValueError(f"2 * block_len must be a square, got {2 * block_len}")
    cost = pair_cost(pair, n_blocks, n_ch, m)
    samples = (n_blocks - 1) * n_ch * block_len
    return cost.bytes / samples, cost.ops / samples
