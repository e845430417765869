"""ZMQ host edge: data/debug publishers + control ROUTER.

Socket layout parity with the reference (SURVEY.md §2.1):
  * PUB  data   :5555 — aligned frames (cpacketizer.cc:58-64)
  * ROUTER ctrl :5556 — console-grammar text commands, 250 ms poll
                  (console.cc:59-81); like the reference, commands are
                  consumed and not replied to (the MEX client never reads
                  replies, zmqsdr.c:152-181)
  * PUB  debug  :5557 — per-frame complex phase-correction factors
                  (cpacketizer.cc:65-66,127)

ZMQ is optional at import time (gated) so the DSP stack works without it.
"""

from typing import Callable, Optional

import numpy as np

try:
    import zmq

    HAVE_ZMQ = True
except ImportError:  # pragma: no cover - zmq is present in CI image
    zmq = None
    HAVE_ZMQ = False

from coherent_rtlsdr_tpu_torch.io.wire import pack_debug, pack_frame


def _require_zmq():
    if not HAVE_ZMQ:
        raise RuntimeError("pyzmq is not available; ZMQ edge disabled")


class FramePublisher:
    """Publishes aligned frames + phase debug — the cpacketize::send loop
    (cpacketizer.cc:109-129) without the double-buffer/condvar machinery
    (the pipeline hands us complete frames; there is nothing to race)."""

    def __init__(
        self,
        data_addr: str = "tcp://*:5555",
        debug_addr: str = "tcp://*:5557",
        header: bool = True,
        context=None,
    ):
        _require_zmq()
        self._ctx = context or zmq.Context.instance()
        self.data = self._ctx.socket(zmq.PUB)
        self.data.bind(data_addr)
        self.debug = self._ctx.socket(zmq.PUB)
        self.debug.bind(debug_addr)
        self.header = header
        self.globalseqn = 0

    def publish(
        self,
        iq_i8: np.ndarray,           # [N, L, 2] int8, channel 0 = reference
        seqnums: np.ndarray,         # [N] uint32 per-channel readcnt
        phases: Optional[np.ndarray] = None,  # [N] complex64 corrections
    ) -> int:
        buf = pack_frame(self.globalseqn, seqnums, iq_i8, header=self.header)
        self.data.send(buf)
        if phases is not None:
            self.debug.send(pack_debug(phases))
        self.globalseqn += 1
        return len(buf)

    def close(self):
        self.data.close(0)
        self.debug.close(0)


class ControlServer:
    """ROUTER control socket fed into a dispatcher callback.

    ``poll(handler)`` drains pending commands; ``handler(text) -> reply`` is
    the console dispatcher. Replies are sent back to the requesting DEALER
    (harmless to reference clients, which never read them; useful for new
    ones)."""

    def __init__(self, addr: str = "tcp://*:5556", context=None, reply: bool = True):
        _require_zmq()
        self._ctx = context or zmq.Context.instance()
        self.sock = self._ctx.socket(zmq.ROUTER)
        self.sock.bind(addr)
        self.reply = reply

    def poll(self, handler: Callable[[str], str], timeout_ms: int = 0) -> int:
        """Process all queued commands; returns the number handled."""
        n = 0
        while True:
            if not self.sock.poll(timeout_ms if n == 0 else 0):
                return n
            parts = self.sock.recv_multipart()
            ident, payload = parts[0], parts[-1]
            text = payload.decode("utf-8", errors="replace")
            try:
                out = handler(text)
            except Exception as e:  # a bad command must never kill the loop
                out = f"error: {e}"
            if self.reply and out is not None:
                self.sock.send_multipart([ident, out.encode("utf-8")])
            n += 1

    def close(self):
        self.sock.close(0)
