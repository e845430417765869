"""Capture file IO.

The reference has no server-side recording (SURVEY.md §5 — capture exists
only client-side via matsave/measurement scripts). Here captures are
first-class: a ``.npz`` with the raw uint8 blocks, so any run is replayable
and benchmarks are reproducible.

Layout:
    sig_u8  [T, N, L, 2] uint8   signal channels
    ref_u8  [T, L, 2] uint8      reference channel
    seqnums [T, N] uint32        per-channel readcnt at each block (gap
                                 detection — cpacketizer.cc:113,142 analog)
    meta: fs, fcenter, block_len (0-d arrays)
"""

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Capture:
    sig_u8: np.ndarray
    ref_u8: np.ndarray
    seqnums: np.ndarray
    fs: float
    fcenter: float

    @property
    def n_blocks(self) -> int:
        return self.sig_u8.shape[0]

    @property
    def n_channels(self) -> int:
        return self.sig_u8.shape[1]

    @property
    def block_len(self) -> int:
        return self.sig_u8.shape[2]


def save_capture(path: str, cap: Capture) -> None:
    np.savez_compressed(
        path,
        sig_u8=cap.sig_u8,
        ref_u8=cap.ref_u8,
        seqnums=cap.seqnums,
        fs=np.float64(cap.fs),
        fcenter=np.float64(cap.fcenter),
    )


def load_capture(path: str) -> Capture:
    z = np.load(path)
    return Capture(
        sig_u8=z["sig_u8"],
        ref_u8=z["ref_u8"],
        seqnums=z["seqnums"],
        fs=float(z["fs"]),
        fcenter=float(z["fcenter"]),
    )


def detect_seqnum_gaps(seqnums: np.ndarray) -> np.ndarray:
    """Per-channel dropped-block counts between consecutive frames.

    The reference delegates gap detection to clients (README.md:42); here it
    is part of the pipeline. Returns ``[T-1, N]`` int64: expected increment
    is 1; larger means drops.
    """
    d = np.diff(seqnums.astype(np.int64), axis=0)
    return d - 1
