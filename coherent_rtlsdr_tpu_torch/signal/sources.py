"""Block sources for the streaming server (port of the synthetic and file
sources of ``coherent_rtlsdr_tpu/signal/sources.py``): the device-capture
layer abstracted to "give me the next block of every channel".

Sources yield ``(sig_u8 [N, L, 2], ref_u8 [L, 2], seqnums [N] uint32)`` as
numpy arrays in host memory. Seqnums mirror the reference's per-buffer
``readcnt``; the drop injection simulates its documented stale-buffer
failure, so the server's gap handling is testable.
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from coherent_rtlsdr_tpu_torch.signal.synth import synth_stream_slab

Block = Tuple[np.ndarray, np.ndarray, np.ndarray]


class SyntheticStreamSource:
    """Streaming wrapper over the synthetic signal model.

    Renders the stream in slabs of ``slab_blocks`` on ``device``
    (``synth_stream_slab``, continuous across slabs), copies each slab to
    host memory once and serves its blocks from there. ``drop_rate``
    injects per-channel block drops (a channel misses one buffer while the
    others advance): a dropped block repeats the channel's previous samples
    and skips a seqnum.
    """

    def __init__(
        self,
        truth,
        block_len: int = 8192,
        slab_blocks: int = 16,
        seed: int = 0,
        drop_rate: float = 0.0,
        refnoise_enabled: bool = True,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SyntheticStreamSource renders its slabs on the card and "
                               "found none; pass device='cpu' to render on the CPU")
        self._truth = truth
        self._L = block_len
        self._slab = slab_blocks
        self._seed = seed
        self._drop_rate = drop_rate
        self._rng = np.random.default_rng(seed + 1)
        self._slab_idx = 0
        self._blk_in_slab = 0
        self._resume = None
        self._sig = None
        self._ref = None
        self._seqnums = np.zeros(len(truth.delays), np.uint32)
        self._prev: Optional[Block] = None
        self.refnoise_enabled = refnoise_enabled
        self.serials = [f"SYN {i}" for i in range(len(truth.delays))]

    # -- hot-plug (console add/del) ---------------------------------------

    @property
    def n_channels(self) -> int:
        return len(self._truth.delays)

    def add_channel(self, serial: str) -> int:
        """Append a new synthetic channel (its truth drawn from a hash of
        the serial); returns its index in the rx matrix."""
        h = np.random.default_rng(abs(hash(serial)) % (2**32))
        t = self._truth
        self._truth = dataclasses.replace(
            t,
            delays=np.append(t.delays, h.uniform(-40, 40)).astype(np.float32),
            phases=np.append(t.phases, h.uniform(-np.pi, np.pi)).astype(np.float32),
            gains=np.append(t.gains, h.uniform(0.7, 1.0)).astype(np.float32),
            ppm=np.append(t.ppm, 0.0).astype(np.float32),
        )
        self.serials.append(serial)
        self._seqnums = np.append(self._seqnums, 0).astype(np.uint32)
        self._invalidate_slab()
        return len(self.serials) - 1

    def del_channel(self, serial: str) -> Optional[int]:
        """Remove a channel by serial; returns its former index or None."""
        if serial not in self.serials:
            return None
        i = self.serials.index(serial)
        t = self._truth
        keep = np.arange(len(t.delays)) != i
        self._truth = dataclasses.replace(
            t, delays=t.delays[keep], phases=t.phases[keep], gains=t.gains[keep],
            ppm=t.ppm[keep],
        )
        self.serials.pop(i)
        self._seqnums = self._seqnums[keep]
        self._invalidate_slab()
        return i

    def _invalidate_slab(self):
        """Drop the rendered slab but keep the stream position: the
        reference timeline is a function of (seed, block index), so the
        slab rendered next resumes where the old one stopped, and a hot
        add/del never disturbs the surviving channels."""
        if self._sig is not None:
            self._resume = (self._slab_idx - 1, self._blk_in_slab)
        self._sig = None
        self._prev = None

    def _fill_slab(self):
        slab_idx, offset = self._slab_idx, 0
        if self._resume is not None:
            slab_idx, offset = self._resume
            self._resume = None
            while offset >= self._slab:   # invalidated exactly at a slab seam
                slab_idx += 1
                offset -= self._slab
        sig_u8, ref_u8 = synth_stream_slab(self._seed, self._truth, slab_idx, self._slab,
                                           self._L, device=self.device)
        self._sig = sig_u8.cpu().numpy()
        self._ref = ref_u8.cpu().numpy()
        self._slab_idx = slab_idx + 1
        self._blk_in_slab = offset

    def next_block(self) -> Block:
        if self._sig is None or self._blk_in_slab >= self._slab:
            self._fill_slab()
        sig = self._sig[self._blk_in_slab]
        ref = self._ref[self._blk_in_slab]
        self._blk_in_slab += 1

        n = sig.shape[0]
        self._seqnums = self._seqnums + 1
        if self._drop_rate > 0.0 and self._prev is not None:
            dropped = self._rng.random(n) < self._drop_rate
            if dropped.any():
                sig = sig.copy()
                sig[dropped] = self._prev[0][dropped]
                self._seqnums = self._seqnums + dropped.astype(np.uint32)
        out = (sig, ref, self._seqnums.copy())
        self._prev = out
        return out


class FileSource:
    """Replays a recorded capture (``io/streamio.py``), optionally looping."""

    def __init__(self, capture, loop: bool = False):
        self._cap = capture
        self._loop = loop
        self._t = 0

    def next_block(self) -> Optional[Block]:
        if self._t >= self._cap.n_blocks:
            if not self._loop:
                return None
            self._t = 0
        t = self._t
        self._t += 1
        return (
            self._cap.sig_u8[t],
            self._cap.ref_u8[t],
            self._cap.seqnums[t].astype(np.uint32),
        )
