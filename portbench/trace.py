"""The traced window (``--trace 1``): torch.profiler over the measured
window, reduced to what the per-layer metrics read.

Device time is the union of the intervals of every operation on the card
(kernels, copies, fills) on all streams, clipped to the window: the server
copies on a side stream beside its compute stream, so summed durations can
overlap. Idle gaps are the holes in that union, labelled by the innermost
host operation that was running at the middle of each.
"""

import contextlib
from typing import Optional

import numpy as np

WINDOW_MARK = "portbench.window"


def union_busy(starts, ends, w0: float, w1: float) -> float:
    """Length of the union of the intervals [start, end), clipped to [w0, w1]."""
    iv = sorted((max(s, w0), min(e, w1)) for s, e in zip(starts, ends) if e > w0 and s < w1)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(starts, ends, w0: float, w1: float):
    """The holes in the union of the intervals within [w0, w1], as (start,
    end) pairs, the stretch before the first and after the last included."""
    iv = sorted((max(s, w0), min(e, w1)) for s, e in zip(starts, ends) if e > w0 and s < w1)
    gaps, t = [], w0
    for s, e in iv:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return gaps


def label_gaps(gaps, host_starts, host_ends, host_names, top: int = 10, scan: int = 400):
    """Seconds of idle device time by the innermost host operation running
    at each gap's middle (``"host python"`` where none ran), over the
    ``scan`` longest gaps: the ``top`` largest ``[name, seconds]``."""
    hs = np.asarray(host_starts, np.float64)
    he = np.asarray(host_ends, np.float64)
    by = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:scan]:
        mid = 0.5 * (a + b)
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        name = ("host python" if inside.size == 0
                else host_names[inside[np.argmin(he[inside] - hs[inside])]])
        by[name] = by.get(name, 0.0) + (b - a)
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


class Trace:
    """``with Trace(on, cuda) as tr: ... with tr.window(): <measured>``, then
    ``tr.summary()``; a no-op when ``on`` is false."""

    def __init__(self, on: bool, cuda: bool):
        self.on, self.cuda = on, cuda
        self.prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)

    @contextlib.contextmanager
    def window(self):
        if self.prof is None:
            yield
            return
        from torch.profiler import record_function

        with record_function(WINDOW_MARK):
            yield

    def summary(self) -> Optional[dict]:
        """busy_s, window_s, device_ops (count), kernel_s (summed kernel
        durations) and the breakdown, over the traced window; None when
        tracing was off."""
        if self.prof is None:
            return None
        import torch

        w0 = w1 = None
        dev_s, dev_e, dev_n, kern = [], [], [], []
        host_s, host_e, host_n = [], [], []
        events = list(self.prof.profiler.kineto_results.events())
        base = min((e.start_ns() for e in events), default=0)
        for e in events:
            s, d, name = (e.start_ns() - base) * 1e-9, e.duration_ns() * 1e-9, e.name()
            if name == WINDOW_MARK:
                # the mark also appears on the card's timeline: not work
                if e.device_type() != torch.autograd.DeviceType.CUDA:
                    w0, w1 = s, s + d
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                dev_s.append(s)
                dev_e.append(s + d)
                dev_n.append(name)
                kern.append(not name.startswith(("Memcpy", "Memset")))
            else:
                host_s.append(s)
                host_e.append(s + d)
                host_n.append(name)
        if w0 is None:
            return None
        inside = [i for i in range(len(dev_s)) if dev_e[i] > w0 and dev_s[i] < w1]
        by_name = {}
        for i in inside:
            by_name[dev_n[i]] = by_name.get(dev_n[i], 0.0) + (min(dev_e[i], w1) - max(dev_s[i], w0))
        busy = union_busy([dev_s[i] for i in inside], [dev_e[i] for i in inside], w0, w1)
        gaps = idle_gaps([dev_s[i] for i in inside], [dev_e[i] for i in inside], w0, w1)
        return dict(
            busy_s=busy, window_s=w1 - w0, device_ops=len(inside),
            kernel_s=sum(dev_e[i] - dev_s[i] for i in inside if kern[i]),
            breakdown=dict(
                device_ops=[[n[:120], s] for n, s in
                            sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
                idle_gaps=label_gaps(gaps, host_s, host_e, host_n)),
        )
