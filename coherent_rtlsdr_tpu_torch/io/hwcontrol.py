"""Hardware drift relief: the reference's ccontrol actuator for real dongles.

The streaming pipeline absorbs all measured lag NUMERICALLY (fractional-
delay correction driven by pipeline/control.py — the tanh law applied as an
exact frequency-domain advance). That is strictly better than the
reference's mechanism while the required advance stays inside
``cfg.max_delay``; but a channel with persistent clock skew accumulates
applied delay without bound, eventually hitting the clamp.

The reference solves drift by *changing the sampling process*: skew the
dongle's hardware resampler off-frequency just long enough to swallow the
lag, then restore (src/ccontrol.cc:78-123). With the librtlsdr capture path
(native.NativeRtlCapture + the tejeez fork's
``rtlsdr_set_sample_freq_correction_f``) that actuator exists here too, so
this module closes the loop the reference way — as periodic RELIEF for the
numerical corrector rather than the sole mechanism:

  * when a channel's applied numerical delay exceeds ``threshold`` samples,
    command correction ``p = MAX_CORR * tanh(delay / SCALE)`` (the exact
    descent law and constants, ccontrol.cc:25-29,73-76) on that dongle for
    dwell ``t = FRAC_T * |delay / (p * fs)|`` seconds, then restore 0.0;
  * the hardware eats the lag during the dwell, the pipeline re-measures,
    and the numerical delay relaxes back toward zero — no sample loss, no
    discontinuity, because the numerical corrector tracks continuously
    through the skew (unlike the reference, which freezes its estimate and
    hopes, ccontrol.cc:85's fragile sleep).

Non-blocking by design: the reference parks one thread per device in
``nanosleep`` (csdrdevice.cc:47); here restores are deadline-checked from
the server's block loop (``tick()``), so no threads are added.
"""

import math
import time
from typing import Dict, List, Optional, Sequence

# ccontrol.cc:25-29 — MAX_CORR is the dimensionless fractional frequency
# offset 2^13/2^24 (~488 ppm as a fraction), passed VERBATIM to
# rtlsdr_set_sample_freq_correction_f like the reference's descent() value;
# the dwell formula t = FRAC_T*|lag/(p*fs)| only produces sensible times
# when p is that fraction, which pins the unit convention.
MAX_CORR = 2.0**13 / 2.0**24
SCALE = 100.0
FRAC_T = 0.90


def descent(lag: float) -> float:
    """ccontrol.cc:73-76 — tanh-damped correction from the current lag."""
    return MAX_CORR * math.tanh(lag / SCALE)


class HwDriftRelief:
    """Drives ``capture.set_correction_f`` from the pipeline's applied
    per-channel numerical delays.

    ``capture`` is a native.NativeRtlCapture (channel 0 = the reference
    dongle — never skewed, like the reference's crefsdr which starts no
    ccontrol, crtlsdr.cc:225-230); signal channel ``i`` of the pipeline maps
    to capture channel ``i + 1``.
    """

    def __init__(
        self,
        capture,
        fs: float,
        threshold: float = 8.0,
        max_dwell_s: float = 5.0,
    ):
        self._cap = capture
        self.fs = float(fs)
        self.threshold = float(threshold)
        self.max_dwell_s = float(max_dwell_s)
        self._restore_at: Dict[int, float] = {}  # signal ch -> deadline
        self.pulses = 0       # corrections commanded (telemetry)
        self.failures = 0     # actuator errors (fork symbol missing, etc.)

    @property
    def active(self) -> List[int]:
        """Signal channels currently mid-dwell."""
        return sorted(self._restore_at)

    def tick(self, delays: Sequence[float], now: Optional[float] = None) -> int:
        """Called once per processed block with the applied numerical delays
        ``[N]`` (PipelineState.delay). Restores dongles whose dwell elapsed;
        starts a correction pulse on channels past the threshold. Returns
        the number of actuator calls made this tick."""
        if now is None:
            now = time.monotonic()
        calls = 0
        for ch, deadline in list(self._restore_at.items()):
            if now >= deadline:
                if self._cap.set_correction_f(ch + 1, 0.0) != 0:
                    self.failures += 1
                del self._restore_at[ch]
                calls += 1
        for ch, delay in enumerate(delays):
            if ch in self._restore_at:
                continue  # mid-dwell: let the hardware work
            d = float(delay)
            if abs(d) <= self.threshold:
                continue
            p = descent(d)
            dwell = min(FRAC_T * abs(d / (p * self.fs)), self.max_dwell_s)
            if self._cap.set_correction_f(ch + 1, p) != 0:
                self.failures += 1
                continue
            self._restore_at[ch] = now + dwell
            self.pulses += 1
            calls += 1
        return calls

    def stop(self, now: Optional[float] = None) -> None:
        """Restore every skewed dongle immediately (shutdown path)."""
        for ch in list(self._restore_at):
            self._cap.set_correction_f(ch + 1, 0.0)
            del self._restore_at[ch]
