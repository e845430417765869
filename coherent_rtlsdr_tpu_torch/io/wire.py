"""The reference's exact ZMQ wire format.

Data frame (include/cpacketizer.h:32-37, src/cpacketizer.cc:91-96,109-172),
all little-endian:

    hdr0:      uint32 globalseqn | uint32 N | uint32 L | uint32 unused
    seqnums:   N x uint32 per-channel readcnt
    payload:   N x (L complex samples as interleaved int8 I,Q)

Channel 0 of the payload is the reference channel (raw passthrough in the
reference, cpacketizer.cc:137-156); channels 1..N-1 are the corrected signal
channels requantized to int8 with scale 127 (cdsp::convto8bit, cdsp.cc:51-54).
``noheader`` ("raw") mode drops hdr0+seqnums (main.cc:105,148-150).

Debug frame on :5557 (cpacketizer.cc:125-134): N complex<float> phase
correction factors, no header.

The MATLAB MEX client parses exactly this (matlabclient/zmqsdr.c:116-150).
"""

import struct
from typing import NamedTuple, Optional, Sequence

import numpy as np

HDR_STRUCT = struct.Struct("<IIII")
HDR_BYTES = HDR_STRUCT.size  # 16


class Frame(NamedTuple):
    globalseqn: int
    seqnums: np.ndarray  # [N] uint32
    iq: np.ndarray       # [N, L, 2] int8


def frame_length(n_channels: int, block_len: int, header: bool = True) -> int:
    """packetlength (cpacketizer.cc:91-96); block_len in complex samples."""
    payload = 2 * n_channels * block_len
    return payload if not header else HDR_BYTES + 4 * n_channels + payload


def pack_frame(
    globalseqn: int,
    seqnums: Sequence[int],
    iq_i8: np.ndarray,
    header: bool = True,
) -> bytes:
    """iq_i8: ``[N, L, 2]`` int8 (channel 0 = reference)."""
    iq = np.ascontiguousarray(iq_i8, dtype=np.int8)
    n, l, _ = iq.shape
    if not header:
        return iq.tobytes()
    return b"".join(
        (
            HDR_STRUCT.pack(globalseqn & 0xFFFFFFFF, n, l, 0),
            np.asarray(seqnums, dtype="<u4").tobytes(),
            iq.tobytes(),
        )
    )


def unpack_frame(
    buf: bytes, header: bool = True, n_channels: Optional[int] = None,
    block_len: Optional[int] = None,
) -> Frame:
    if header:
        # Validate before trusting network-supplied geometry: a truncated
        # or hostile frame must raise ValueError (callers skip it), never
        # struct.error / a huge allocation.
        if len(buf) < HDR_BYTES:
            raise ValueError(f"frame too short for hdr0: {len(buf)} bytes")
        gseq, n, l, _ = HDR_STRUCT.unpack_from(buf, 0)
        if len(buf) != frame_length(n, l):
            raise ValueError(
                f"frame length {len(buf)} != hdr0 geometry N={n} L={l} "
                f"({frame_length(n, l)} bytes)"
            )
        off = HDR_BYTES
        seqnums = np.frombuffer(buf, dtype="<u4", count=n, offset=off).copy()
        off += 4 * n
    else:
        if n_channels is None or block_len is None:
            raise ValueError("raw frames need explicit n_channels/block_len")
        gseq, n, l = 0, n_channels, block_len
        seqnums = np.zeros(n, np.uint32)
        off = 0
    iq = (
        np.frombuffer(buf, dtype=np.int8, count=2 * n * l, offset=off)
        .reshape(n, l, 2)
        .copy()
    )
    return Frame(globalseqn=gseq, seqnums=seqnums, iq=iq)


def pack_debug(phases: np.ndarray) -> bytes:
    """N complex64 phase-correction factors (cpacketizer.cc:127,131-134)."""
    return np.ascontiguousarray(phases, dtype=np.complex64).tobytes()


def unpack_debug(buf: bytes) -> np.ndarray:
    return np.frombuffer(buf, dtype=np.complex64).copy()


def frame_to_matrix(frame: Frame, scale: float = 1.0 / 128.0) -> np.ndarray:
    """int8 frame -> ``[N, L]`` complex64 — the MEX client's conversion
    (zmqsdr.c:128-135 scales by 1/128)."""
    f = frame.iq.astype(np.float32) * scale
    return (f[..., 0] + 1j * f[..., 1]).astype(np.complex64)
