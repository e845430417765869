"""The reference system's ZMQ wire format, as the benchmark's sink packs it.

Frozen copy of ``coherent_rtlsdr_tpu_torch/io/wire.py`` (``HDR_STRUCT``,
``frame_length``, ``pack_frame``, ``pack_debug``, ``unpack_frame``) at
commit eccdfa5; ``tests/test_portbench_copies.py`` holds it equal to the
original. All little-endian:

    hdr0:      uint32 globalseqn | uint32 N | uint32 L | uint32 unused
    seqnums:   N x uint32 per-channel readcnt
    payload:   N x (L complex samples as interleaved int8 I,Q)

Channel 0 of the payload is the reference channel. The debug frame is N
complex64 phase-correction factors.
"""

import struct
from typing import NamedTuple, Sequence

import numpy as np

HDR_STRUCT = struct.Struct("<IIII")
HDR_BYTES = HDR_STRUCT.size  # 16


class Frame(NamedTuple):
    globalseqn: int
    seqnums: np.ndarray  # [N] uint32
    iq: np.ndarray       # [N, L, 2] int8


def frame_length(n_channels: int, block_len: int) -> int:
    return HDR_BYTES + 4 * n_channels + 2 * n_channels * block_len


def pack_frame(globalseqn: int, seqnums: Sequence[int], iq_i8: np.ndarray) -> bytes:
    """iq_i8: ``[N, L, 2]`` int8 (channel 0 = reference)."""
    iq = np.ascontiguousarray(iq_i8, dtype=np.int8)
    n, l, _ = iq.shape
    return b"".join((
        HDR_STRUCT.pack(globalseqn & 0xFFFFFFFF, n, l, 0),
        np.asarray(seqnums, dtype="<u4").tobytes(),
        iq.tobytes(),
    ))


def unpack_frame(buf: bytes) -> Frame:
    if len(buf) < HDR_BYTES:
        raise ValueError(f"frame too short for hdr0: {len(buf)} bytes")
    gseq, n, l, _ = HDR_STRUCT.unpack_from(buf, 0)
    if len(buf) != frame_length(n, l):
        raise ValueError(f"frame length {len(buf)} != hdr0 geometry N={n} L={l}")
    seqnums = np.frombuffer(buf, dtype="<u4", count=n, offset=HDR_BYTES).copy()
    iq = np.frombuffer(buf, dtype=np.int8, count=2 * n * l,
                       offset=HDR_BYTES + 4 * n).reshape(n, l, 2).copy()
    return Frame(globalseqn=gseq, seqnums=seqnums, iq=iq)


def pack_debug(phases: np.ndarray) -> bytes:
    """N complex64 phase-correction factors."""
    return np.ascontiguousarray(phases, dtype=np.complex64).tobytes()
