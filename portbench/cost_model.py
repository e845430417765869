"""Bytes and matrix operations of the fused path's three kernels, from their
shapes, and the least time the card could take for them.

Frozen copy of ``coherent_rtlsdr_tpu_torch/tools/cost_model.py`` (``Cost``,
``bound``, ``measure_ref``, ``measure_i8_spec``, ``apply_spec_i8``, the
handoff pair of ``pair_cost``) at commit eccdfa5;
``tests/test_portbench_copies.py`` holds it equal to the original.

For each kernel, the bytes it must move (each input read once, each output
written once) and the operations of its matrix products: 8 m^3 for a
complex m x m by m x m product. A forward four-step transform is two such
products (16 m^3), the apply's inverse over the centre rows one and a half
(12 m^3). T blocks of W = m*m int8 bytes a channel, N channels, T - 1
overlap-save windows a channel. The count is of the work the algorithm
needs, whatever kernels a later change launches for it.
"""

from typing import NamedTuple

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and dense bf16 FLOP/s.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12


class Cost(NamedTuple):
    bytes: int
    ops: int


def bound_s(cost: Cost) -> float:
    """The larger of the bytes over the HBM rate and the operations over the
    bf16 peak, in seconds."""
    return max(cost.bytes / HBM_BYTES_S, cost.ops / BF16_FLOPS)


def _transform_ops(m: int) -> int:
    return 16 * m ** 3


def measure_ref(T: int, m: int) -> Cost:
    W = m * m
    return Cost(T * W + (T - 1) * (W * 8 + 4), (T - 1) * _transform_ops(m))


def measure_i8_spec(T: int, N: int, m: int) -> Cost:
    W, nwin = m * m, (T - 1) * N
    nbytes = T * N * W + (T - 1) * (W * 8 + 4) + 5 * nwin * 4 + 2 * nwin * W * 2
    return Cost(nbytes, nwin * _transform_ops(m))


def apply_spec_i8(T: int, N: int, m: int) -> Cost:
    W, nwin = m * m, (T - 1) * N
    return Cost(2 * nwin * W * 2 + 3 * nwin * 4 + nwin * W, nwin * 12 * m ** 3)

