"""Telemetry recording and timing.

The reference records timestamps it never reads and has no profiling
(SURVEY.md §5). Here: a ring of per-block telemetry (lags, mags, phases,
residuals, block latency) queryable by the console `status`/`phase`
commands, wall-clock throughput counters for the bench harness, and the
host spans of the server loop, the step, the kernels' dispatch and the
offline engine (``SpanRecorder``, one per process: ``SPANS``).
"""

import collections
import itertools
import threading
import time
from typing import Deque, Dict, Optional

import numpy as np
import torch


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


def _bounds_ns(t0: Optional[float], t1: Optional[float]):
    """[t0, t1) in ``time.perf_counter`` seconds as ns bounds (None: open)."""
    return (-1 if t0 is None else int(t0 * 1e9),
            float("inf") if t1 is None else int(t1 * 1e9))


class _Off:
    """The span of a recorder that is not recording: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("_rec", "_name", "_request", "_stack", "_id", "_parent", "_range", "_t0")

    def __init__(self, rec, name, request):
        self._rec, self._name, self._request = rec, name, request

    def __enter__(self):
        rec = self._rec
        stack = rec._stack()
        if stack:
            self._parent, inherited = stack[-1]
            if self._request is None:
                self._request = inherited
        else:
            self._parent = None
        self._id = next(rec._ids)
        stack.append((self._id, self._request))
        self._stack = stack
        self._range = None
        if rec.profiling and threading.get_ident() == rec._poll_thread:
            self._range = torch._C._profiler._RecordFunctionFast(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._stack.pop()
        self._rec._add((self._name, self._t0, t1, self._id, self._parent,
                        threading.get_ident(), self._request))
        return False


class _Poll:
    """One unit of work's reading of the profiler's state (:meth:`SpanRecorder.poll`)."""

    __slots__ = ("_rec", "_prof")

    def __init__(self, rec):
        self._rec = rec

    def __enter__(self) -> bool:
        rec = self._rec
        self._prof = rec.profiling
        prof = torch.autograd._profiler_enabled()
        rec._poll_thread = threading.get_ident()
        rec._set(prof or rec._enabled, prof)
        return rec.on

    def __exit__(self, *exc):
        # back to the enclosing unit's reading, or to enable()'s alone
        self._rec._set(self._prof or self._rec._enabled, self._prof)
        return False


class SpanRecorder:
    """Host spans, kept in memory: ``with SPANS.span(name): ...`` records
    the name, start and end (``time.perf_counter_ns``), the enclosing span
    of the same thread (its parent), the thread, and the request the work
    belongs to (the server's global block index, the offline call's index;
    a span without one takes its parent's).

    Recording is on while torch.profiler is active, or between
    :meth:`enable` and :meth:`disable`. The thread that drives the work
    reads that state once per unit of work (``with SPANS.poll():``, the
    server loop each iteration, ``align_offline`` each call) into the
    ``on`` flag that its spans read, and the flag falls back when the unit
    ends, so work outside one (a direct call of a step) records nothing
    unless :meth:`enable` is in force; the server's publisher worker is handed the flag with
    each batch (``span(..., on=flag)``), because a Python thread never sees
    the profiler as active. Off, a span costs the flag read and an empty
    context manager.

    While the profiler is active, each span of the polling thread is also a
    ``_RecordFunctionFast`` range: a host operation in the profiler's trace
    (never a user annotation, so nothing of it lands on the card's
    timeline), by which the trace's idle gaps are named. The worker's spans
    appear only here; ``anchor`` places any span on the profiler's unix-ns
    clock (:meth:`to_unix_ns`).

    Holds ``capacity`` spans (a 60 s traced flood window is ~20 spans a
    block at up to 300 blocks a second); past it, spans are dropped and
    counted (``dropped``), and :meth:`clear` starts afresh."""

    def __init__(self):
        self.capacity = 1 << 19
        self.on = False          # recording: the flag every span reads
        self.profiling = False   # torch.profiler active, as the last poll read it
        self.anchor = None       # (perf_counter_ns, time_ns) when recording first turned on
        self.dropped = 0
        self._enabled = False
        self._poll_thread = None
        self._spans = []         # (name, t0_ns, t1_ns, id, parent id, thread, request)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def poll(self) -> _Poll:
        """``with SPANS.poll() as on:`` reads the profiler's state into
        ``on`` for one unit of work, and restores the flag when it ends."""
        return _Poll(self)

    def enable(self) -> None:
        """Record until :meth:`disable`, with or without the profiler."""
        self._enabled = True
        self._set(True, self.profiling)

    def disable(self) -> None:
        self._enabled = False
        self._set(False, False)

    def _set(self, on: bool, prof: bool) -> None:
        if on and self.anchor is None:
            self.anchor = (time.perf_counter_ns(), time.time_ns())
        self.on, self.profiling = on, prof

    def clear(self) -> None:
        with self._lock:
            self._spans = []
            self.dropped = 0
            self.anchor = None

    def span(self, name: str, request: Optional[int] = None, on: Optional[bool] = None):
        """A context manager recording one span when ``on`` (by default the
        recorder's flag) is true."""
        if not (self.on if on is None else on):
            return _OFF
        return _Span(self, name, request)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _add(self, rec: tuple) -> None:
        if len(self._spans) < self.capacity:
            self._spans.append(rec)
        else:
            with self._lock:
                self.dropped += 1

    def spans(self, t0: Optional[float] = None, t1: Optional[float] = None) -> list:
        """The spans that start in [t0, t1) (``time.perf_counter`` seconds;
        None for no bound) as dicts: name, t0_ns, t1_ns, id, parent,
        thread, request."""
        lo, hi = _bounds_ns(t0, t1)
        keys = ("name", "t0_ns", "t1_ns", "id", "parent", "thread", "request")
        return [dict(zip(keys, s)) for s in list(self._spans) if lo <= s[1] < hi]

    def summary(self, t0: Optional[float] = None, t1: Optional[float] = None) -> dict:
        """Over the spans that start in [t0, t1): ``{"dropped": spans
        dropped since the last clear, "spans": {name: {"count",
        "total_ms", "self_ms", "max_ms"}}}``. A span's self time is its
        duration less its child spans' (children on one thread nest
        inside their parent and do not overlap)."""
        spans = list(self._spans)
        child_ns = collections.defaultdict(int)
        for s in spans:
            if s[4] is not None:
                child_ns[s[4]] += s[2] - s[1]
        lo, hi = _bounds_ns(t0, t1)
        by = {}
        for name, a, b, sid, _, _, _ in spans:
            if not lo <= a < hi:
                continue
            d = by.setdefault(name, dict(count=0, total_ms=0.0, self_ms=0.0, max_ms=0.0))
            d["count"] += 1
            d["total_ms"] += (b - a) * 1e-6
            d["self_ms"] += (b - a - child_ns[sid]) * 1e-6
            d["max_ms"] = max(d["max_ms"], (b - a) * 1e-6)
        return {"dropped": self.dropped, "spans": by}

    def ms_per(self, name: str, t0: Optional[float], n: Optional[int] = None,
               field: str = "total_ms") -> Optional[float]:
        """The ``field`` of the spans named ``name`` (a name ending in
        ``.``: every span under it) that start at or after ``t0``, summed,
        over ``n`` units of work (None: over the spans found). None where
        there is no window, no unit, no such span, or a span was dropped."""
        if t0 is None or (n is not None and n <= 0):
            return None
        s = self.summary(t0)
        ds = [d for k, d in s["spans"].items()
              if k == name or (name.endswith(".") and k.startswith(name))]
        if s["dropped"] or not ds:
            return None
        return sum(d[field] for d in ds) / (sum(d["count"] for d in ds) if n is None else n)

    def to_unix_ns(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` time on the unix-ns clock of torch.profiler's
        events, through the anchor taken when recording first turned on
        (after the last :meth:`clear`)."""
        return t_ns - self.anchor[0] + self.anchor[1]


# The process's recorder: every span of the port goes here.
SPANS = SpanRecorder()
