"""Arithmetic that the metric readers share: the whole window's rates
and device shares, from what the driver and the trace recorded."""

import numpy as np


def frames_by_end(run) -> int:
    """Frames received by the end of the window."""
    return int(np.sum(run.data["recv"] <= run.data["t_end"]))


def idle_share(run):
    """1 - (union of the card's busy intervals) / window; None untraced or
    where the card ran nothing."""
    t = run.trace
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]


def per_block(run, key: str, scale: float = 1.0):
    t = run.trace
    blocks = run.data.get("blocks", 0)
    if not t or t["busy_s"] <= 0 or blocks <= 0:
        return None
    return t[key] * scale / blocks
