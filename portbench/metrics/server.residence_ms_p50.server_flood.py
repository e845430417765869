"""Median over the window's frames of the source's hand-over to the sink's
receipt, in ms: the time a block spends in the server loop and its
publisher worker."""

import numpy as np


def read(run):
    d = run.data
    if "handoff" not in d or d["blocks"] == 0:
        return None
    n = min(len(d["handoff"]), len(d["recv"]))
    res = d["recv"][:n] - d["handoff"][:n]
    res = res[np.isfinite(res)]
    return float(np.median(res)) * 1e3 if res.size else None
