"""The rate, residence and device-share arithmetic on hand-made timestamps."""

import math
import types

import numpy as np
import pytest

import _tiny  # noqa: F401
from portbench import harness, readings, trace


def _run(data=None, tr=None, seconds=10.0, setup_s=None):
    return types.SimpleNamespace(data=data or {}, trace=tr, seconds=seconds, setup_s=setup_s)


def read(name, run):
    return harness.reader(name)(run)


def test_union_across_two_streams():
    # compute stream [0, 4) and [6, 8); copy stream [3, 7) overlaps both
    starts, ends = [0.0, 6.0, 3.0], [4.0, 8.0, 7.0]
    assert trace.union_busy(starts, ends, 0.0, 10.0) == pytest.approx(8.0)
    assert sum(e - s for s, e in zip(starts, ends)) == pytest.approx(10.0)  # the summed durations
    assert trace.idle_gaps(starts, ends, 0.0, 10.0) == [(8.0, 10.0)]


def test_union_clips_to_the_window():
    assert trace.union_busy([-5.0, 9.0], [1.0, 20.0], 0.0, 10.0) == pytest.approx(2.0)
    assert trace.idle_gaps([-5.0, 9.0], [1.0, 20.0], 0.0, 10.0) == [(1.0, 9.0)]


def test_stalled_window_idle_share():
    """A window in which the card stops for 6 of 10 s reads 0.6 idle."""
    tr = dict(busy_s=trace.union_busy([0.0, 8.0], [2.0, 10.0], 0.0, 10.0), window_s=10.0)
    assert readings.idle_share(_run(tr=tr)) == pytest.approx(0.6)
    assert read("device.idle_share.server_flood", _run(tr=tr)) == pytest.approx(0.6)
    assert readings.idle_share(_run(tr=dict(busy_s=0.0, window_s=10.0))) is None


def test_label_gaps_by_innermost_host_op():
    gaps = [(1.0, 3.0), (5.0, 5.5), (8.0, 9.0)]
    hs, he, names = [0.0, 1.5, 4.0], [4.0, 2.5, 6.0], ["outer", "inner", "other"]
    got = trace.label_gaps(gaps, hs, he, names)
    assert got == [["inner", 2.0], ["host python", 1.0], ["other", 0.5]]


def test_flood_rate_counts_frames_by_the_window_end():
    recv = np.array([0.5, 1.0, 9.9, 10.0, 10.2, np.inf])
    run = _run(dict(recv=recv, t_end=10.0, n_channels=21, block_len=8192), seconds=10.0)
    assert read("server_samples_per_s", run) == 4 * 21 * 8192 / 10.0


def test_residence_median_from_handoff_to_receipt():
    handoff = np.arange(100) * 0.004
    recv = handoff + 0.004
    recv[-3:] += 0.1
    run = _run(dict(recv=recv, blocks=100, handoff=handoff))
    assert read("server.residence_ms_p50.server_flood", run) == pytest.approx(4.0)
    recv[:60] = np.inf                        # frames never received are left out
    assert read("server.residence_ms_p50.server_flood", run) == pytest.approx(4.0)
    assert read("server.residence_ms_p50.server_flood", _run(dict(blocks=0))) is None


def test_offline_rate_and_roofline():
    data = dict(calls=1000, wall_s=2.5, T=256, n_channels=21, block_len=8192)
    assert read("offline_samples_per_s", _run(data)) == 255 * 21 * 8192 * 1000 / 2.5
    from portbench import cost_model as cm

    bound = (cm.bound_s(cm.measure_ref(256, 128)) + cm.bound_s(cm.measure_i8_spec(256, 21, 128))
             + cm.bound_s(cm.apply_spec_i8(256, 21, 128)))
    tr = dict(busy_s=2.4, window_s=2.5)
    assert read("fused_pair_roofline", _run(data, tr)) == pytest.approx(100 * bound * 1000 / 2.4)
    assert 0.30e-3 < bound < 0.36e-3
    assert read("fused_pair_roofline", _run(data)) is None
    assert read("device.idle_share.offline", _run(data, tr)) == pytest.approx(0.04)


def test_per_block_device_metrics():
    tr = dict(busy_s=1.0, window_s=10.0, device_ops=9200, kernel_s=0.5)
    run = _run(dict(blocks=100), tr)
    assert read("step.device_kernels_per_block.server_flood", run) == 92.0
    assert read("kernels.device_ms_per_block.server_flood", run) == pytest.approx(5.0)
    assert read("setup_s", _run(setup_s=12.5)) == 12.5
    assert math.isfinite(read("kernels.device_ms_per_block.server_flood", run))
