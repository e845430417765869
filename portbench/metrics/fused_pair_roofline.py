"""The fused pair's share of its roofline over the traced calls, in %: the
least time the card could take for one call's work (the sum, over
``fused_measure_ref``, ``fused_measure_i8_spec`` and ``fused_apply_spec_i8``
at the call's T, N and m, of the larger of bytes / 3.35 TB/s and operations
/ 989 TFLOP/s, from ``portbench/cost_model.py``), over the card's busy time
a call. It counts the same work whatever kernels run it."""

import math

from portbench import cost_model as cm


def read(run):
    d, t = run.data, run.trace
    if not t or t["busy_s"] <= 0 or d.get("calls", 0) <= 0:
        return None
    T, N = d["T"], d["n_channels"]
    m = math.isqrt(2 * d["block_len"])
    bound = (cm.bound_s(cm.measure_ref(T, m)) + cm.bound_s(cm.measure_i8_spec(T, N, m))
             + cm.bound_s(cm.apply_spec_i8(T, N, m)))
    return 100.0 * bound * d["calls"] / t["busy_s"]
