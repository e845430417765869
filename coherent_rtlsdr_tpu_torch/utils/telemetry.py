"""Telemetry recording and timing.

The reference records timestamps it never reads and has no profiling
(SURVEY.md §5). Here: a ring of per-block telemetry (lags, mags, phases,
residuals, block latency) queryable by the console `status`/`phase`
commands, plus wall-clock throughput counters for the bench harness.
"""

import collections
import threading
import time
from typing import Deque, Dict, Optional

import numpy as np


class BlockTimer:
    """Rolling block-latency / throughput statistics."""

    def __init__(self, window: int = 256):
        self._dts: Deque[float] = collections.deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._dts.append(now - self._last)
        self._last = now

    @property
    def mean_dt(self) -> float:
        return float(np.mean(self._dts)) if self._dts else float("nan")

    def blocks_per_s(self) -> float:
        m = self.mean_dt
        return 1.0 / m if m and m == m and m > 0 else float("nan")


class TelemetryRecorder:
    """Ring buffer of per-block telemetry arrays (host-side).

    Keeps the last ``window`` blocks of each named series; ``summary()``
    renders the status-style table, ``history(name)`` returns [W, ...] for
    the phase-drift analysis the reference does in MATLAB
    (phasecorrectionplot.m).

    Thread-safe: the streaming server records from its publisher worker
    thread while the console (main thread) reads `status`/`phase`."""

    def __init__(self, window: int = 1024):
        self._window = window
        self._data: Dict[str, Deque[np.ndarray]] = collections.defaultdict(
            lambda: collections.deque(maxlen=window)
        )
        self._lock = threading.Lock()
        self.timer = BlockTimer()

    def record(self, **series: np.ndarray) -> None:
        with self._lock:
            self.timer.tick()
            for k, v in series.items():
                a = np.asarray(v)
                d = self._data[k]
                # a width change (hot add/del) makes old rows unstackable;
                # in-flight batches can still record old-width rows AFTER a
                # resize (publisher worker), so reset on mismatch here — the
                # only place with the ordering knowledge
                if d and d[-1].shape != a.shape:
                    d.clear()
                d.append(a)

    def history(self, name: str) -> np.ndarray:
        with self._lock:
            d = list(self._data[name])
        return np.stack(d) if d else np.zeros((0,))

    def last(self, name: str) -> Optional[np.ndarray]:
        with self._lock:
            return self._data[name][-1] if self._data[name] else None

    def n_recorded(self, name: str) -> int:
        with self._lock:
            return len(self._data[name])

    def clear(self) -> None:
        """Drop the history (e.g. after a channel-set change: per-channel
        series of different widths cannot stack, and drift statistics
        across a hot add/del are meaningless anyway)."""
        with self._lock:
            self._data.clear()

    def phase_drift_deg_rms(self) -> float:
        """Residual phase stability over the window — the
        phasecorrectionplot.m metric as a number."""
        h = self.history("phase")
        if h.size == 0:
            return float("nan")
        ang = np.degrees(np.angle(h * np.conj(h.mean(axis=0, keepdims=True))))
        return float(np.sqrt(np.mean(ang**2)))
