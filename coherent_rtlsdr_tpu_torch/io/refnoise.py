"""Reference-noise calibration switch driver.

Hardware parity with ``crefnoise`` (include/crefnoise.h:24-58) and the STM32
firmware char protocol (refnoisefirmware/fw.c:254-293): single characters on
a CDC-ACM serial device —

    host set_state(True)  -> 'x'   (noise amplifiers on)
    host set_state(False) -> 'o'   (firmware ignores unknown chars; the
                                    effective protocol is defined by the
                                    firmware's X/x handling — we reproduce
                                    the *host's* observed behavior exactly,
                                    crefnoise.h:30-38)
    fan: 'F' on / 'f' off          (fw.c:311-333)

In simulation, the same object just tracks the flag that gates phase
re-estimation (ccoherent.cc:271) — which is how the pipeline consumes it.
"""

import os
from typing import Optional


class RefNoise:
    def __init__(self, device: Optional[str] = "/dev/ttyACM0", enable_on_open: bool = True):
        """``device=None`` -> pure simulation (no hardware writes)."""
        self._fd = None
        self._enabled = False
        if device is not None and os.path.exists(device):
            self._fd = os.open(device, os.O_WRONLY | os.O_NOCTTY)
        if enable_on_open:
            self.set_state(True)  # the reference enables noise at startup
                                  # (main.cc:183 opens with noise ON)

    def _write(self, ch: bytes) -> None:
        if self._fd is not None:
            os.write(self._fd, ch)

    def set_state(self, enabled: bool) -> None:
        """crefnoise::set_state (crefnoise.h:30-38)."""
        self._write(b"x" if enabled else b"o")
        self._enabled = bool(enabled)

    def set_fan(self, on: bool) -> None:
        """Fan control (fw.c:311-333)."""
        self._write(b"F" if on else b"f")

    @property
    def isenabled(self) -> bool:
        """crefnoise::isenabled — gates phase re-estimation in the hot loop."""
        return self._enabled

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
