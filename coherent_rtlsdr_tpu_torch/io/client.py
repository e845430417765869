"""CoherentClient — the Python analog of the reference's MATLAB client
(matlabclient/CZMQSDR.m + zmqsdr.c): receive aligned frames as a complex
matrix and drive the server over the console-text control socket.

The MEX client's contract is reproduced exactly:
  * ``read()`` = zmqsdr.c 'r' (zmqsdr.c:116-150): recv one frame, scale
    int8 by 1/128 into an [N, L] complex64 matrix, return it with the
    frame's global seqnum and the per-channel capture seqnums.
  * control ops send the console grammar strings the reference sends
    (zmqsdr.c:152-181): ``fcenter <hz>``, ``request re|rd``,
    ``request sync`` — plus everything else the console accepts via
    :meth:`command`.
  * like CZMQSDR.m, assigning :attr:`center_frequency` retunes the server
    (CZMQSDR.m:52-71), with the same 24-1766 MHz validation
    (CZMQSDR.m:45-49), and ``read()`` retries on timeout up to
    ``max_retries`` (CZMQSDR.m:83-103).
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np

from coherent_rtlsdr_tpu_torch.io.wire import frame_to_matrix, unpack_frame

FC_MIN_HZ = 24e6      # CZMQSDR.m:45-49 validation range
FC_MAX_HZ = 1766e6


@dataclasses.dataclass
class ClientFrame:
    """One received frame: channel 0 is the reference (ccoherent.cc:253)."""

    x: np.ndarray          # [N, L] complex64, int8 wire scaled by 1/128
    globalseqn: int        # frame counter (hdr0)
    seqnums: np.ndarray    # [N] uint32 per-channel capture seqnums


class CoherentClient:
    """SUB data + DEALER control client for a coherent server (ours or the
    reference binary — the wire and grammar are identical)."""

    def __init__(
        self,
        data_addr: str = "tcp://localhost:5555",
        ctrl_addr: str = "tcp://localhost:5556",
        debug_addr: Optional[str] = None,
        timeout_ms: int = 500,    # zmqsdr.c:82 uses 500 ms on the SUB
        max_retries: int = 10,    # CZMQSDR.m retry counter
        context=None,
    ):
        import zmq

        self._zmq = zmq
        self._ctx = context or zmq.Context.instance()
        self._sub = self._ctx.socket(zmq.SUB)
        self._sub.setsockopt(zmq.SUBSCRIBE, b"")
        self._sub.setsockopt(zmq.RCVTIMEO, timeout_ms)
        self._sub.connect(data_addr)
        self._ctl = self._ctx.socket(zmq.DEALER)
        self._ctl.setsockopt(zmq.RCVTIMEO, max(timeout_ms, 5000))
        self._ctl.connect(ctrl_addr)
        self._dbg = None
        if debug_addr:
            self._dbg = self._ctx.socket(zmq.SUB)
            self._dbg.setsockopt(zmq.SUBSCRIBE, b"")
            self._dbg.setsockopt(zmq.RCVTIMEO, timeout_ms)
            self._dbg.connect(debug_addr)
        self.max_retries = max_retries
        self._fc: Optional[float] = None
        self._refnoise: Optional[bool] = None
        self._replies = False  # has this server ever sent a console reply?

    # ---- data plane -----------------------------------------------------

    def read(self) -> Optional[ClientFrame]:
        """One frame as an [N, L] complex matrix (N includes the reference
        at row 0). Retries timeouts up to ``max_retries`` (CZMQSDR.m
        stepImpl); returns None when the stream stays silent."""
        for _ in range(self.max_retries):
            try:
                buf = self._sub.recv()
            except self._zmq.Again:
                continue
            try:
                f = unpack_frame(buf)
            except ValueError:  # malformed frame: skip, keep retrying
                self.malformed = getattr(self, "malformed", 0) + 1
                continue
            return ClientFrame(
                x=frame_to_matrix(f),  # 1/128 scale, zmqsdr.c:128-135
                globalseqn=int(f.globalseqn),
                seqnums=f.seqnums,
            )
        return None

    def read_phases(self) -> Optional[np.ndarray]:
        """One :5557 debug frame: the per-channel complex correction
        factors (requires ``debug_addr``; phasecorrectionplot.m's input)."""
        if self._dbg is None:
            raise RuntimeError("client was created without debug_addr")
        try:
            return np.frombuffer(self._dbg.recv(), np.complex64).copy()
        except self._zmq.Again:
            return None

    # ---- control plane (console grammar = the network protocol) ---------

    def command(self, line: str) -> str:
        """Send one console-grammar command, return the server's reply
        (the reference's clients never read replies — zmqsdr.c:152-181 —
        but our server sends them; they are safe to ignore)."""
        # drain any late reply from a previously timed-out command, else
        # request/reply pairing desyncs forever (first TPU claim stalls
        # the server loop for minutes — CLAUDE.md rule 4)
        while self._ctl.poll(0):
            self._note_late_reply(self._ctl.recv())
        self._ctl.send_string(line)
        try:
            out = self._ctl.recv().decode()
            self._replies = True
            if not line.startswith("fcenter"):
                # a mismatched reply (a previous timed-out command's
                # verdict landing as this one's) still carries information
                self._note_late_reply(out.encode())
            return out
        except self._zmq.Again:
            return ""

    def _note_late_reply(self, msg: bytes) -> None:
        """A reply belonging to an EARLIER (timed-out) command: it proves
        the server replies, and a late 'fcenter retune FAILED' verdict
        means an optimistically-cached retune (the first-command case —
        nothing had yet proved this server replies) never took effect:
        mark the cached fc unknown rather than keep lying."""
        self._replies = True
        if b"fcenter retune FAILED" in msg:
            self._fc = None

    @property
    def center_frequency(self) -> Optional[float]:
        return self._fc

    @center_frequency.setter
    def center_frequency(self, hz: float):
        if not (FC_MIN_HZ <= hz <= FC_MAX_HZ):
            raise ValueError(
                f"center frequency {hz:.0f} outside {FC_MIN_HZ:.0f}-"
                f"{FC_MAX_HZ:.0f} Hz (CZMQSDR.m:45-49)"
            )
        reply = self.command(f"fcenter {hz:.0f}")
        # Our server reports a failed retune ('fcenter retune FAILED ...',
        # io/server.py) and keeps the old tuning — don't let the cached fc
        # disagree with the array. An empty reply means either the
        # reference binary (which never replies — success by convention)
        # or a TIMEOUT from a server known to reply (outcome unknown, e.g.
        # stalled in a TPU claim): only trust silence from a server that
        # has never replied.
        if "FAILED" in reply or (reply == "" and self._replies):
            return
        self._fc = hz

    @property
    def refnoise_enabled(self) -> Optional[bool]:
        return self._refnoise

    @refnoise_enabled.setter
    def refnoise_enabled(self, on: bool):
        self.command("request re" if on else "request rd")  # zmqsdr.c 'e'/'d'
        self._refnoise = bool(on)

    def request_sync(self):
        """Force a full re-synchronization (zmqsdr.c 's')."""
        self.command("request sync")

    def status(self) -> str:
        return self.command("status")

    def close(self):
        self._sub.close(0)
        self._ctl.close(0)
        if self._dbg is not None:
            self._dbg.close(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
