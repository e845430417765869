"""The port's host spans (CPU): the recorder (``utils/telemetry.py:
SpanRecorder``), its ranges in torch.profiler's trace, the spans of the
server loop, the step, the kernels' dispatch and the offline engine, and
the benchmark's eight readers of them."""

import threading
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig
from coherent_rtlsdr_tpu_torch.pipeline.offline import align_offline
from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_capture
from coherent_rtlsdr_tpu_torch.signal.sources import SyntheticStreamSource
from coherent_rtlsdr_tpu_torch.utils import SPANS, SpanRecorder
from portbench import harness

L = 2048
FUSED = dict(n_channels=3, block_len=L, fft_impl="fused", lag_method="phase_zoom")
LOOP = ("server.block", "server.source", "server.stage", "server.dispatch",
        "server.queue_wait", "server.control")
WORKER = ("server.publish_batch", "server.fetch", "server.publish")
STEP = ("step.measure", "step.control", "step.apply", "step.telemetry")
KERNELS = ("kernels.measure_ref", "kernels.measure_spec", "kernels.apply_spec_i8")


@pytest.fixture
def spans():
    """The process's recorder, empty and off before and after the test."""
    SPANS.disable()
    SPANS.clear()
    yield SPANS
    SPANS.disable()
    SPANS.clear()


class _Publisher:
    def publish(self, iq_i8, seqnums, phases=None):
        return iq_i8.size


class _Control:
    def poll(self, handler, timeout_ms=0):
        return 0


def _server(scan_depth):
    truth = make_truth(3, seed=0, max_delay=20.0, snr_db=30.0)
    src = SyntheticStreamSource(truth, block_len=L, slab_blocks=8, seed=0, device="cpu")
    return CoherentServer(PipelineConfig(**FUSED), src, publisher=_Publisher(),
                          control=_Control(), scan_depth=scan_depth, device="cpu")


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


# ---- the recorder ------------------------------------------------------------

def test_nesting_parent_thread_and_request():
    rec = SpanRecorder()
    rec.enable()
    with rec.span("outer", 7):
        with rec.span("inner"):
            pass
        with rec.span("other", 9):
            pass
    worker = {}

    def work():
        with rec.span("worker", 3, on=True):
            with rec.span("worker.child", on=True):
                worker["thread"] = threading.get_ident()

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    by = {s["name"]: s for s in rec.spans()}
    assert by["outer"]["parent"] is None and by["outer"]["request"] == 7
    assert by["inner"]["parent"] == by["outer"]["id"] and by["inner"]["request"] == 7
    assert by["other"]["parent"] == by["outer"]["id"] and by["other"]["request"] == 9
    assert by["outer"]["thread"] == by["inner"]["thread"] == threading.get_ident()
    # a thread's first span has no parent, whatever the other thread holds
    assert by["worker"]["parent"] is None and by["worker"]["thread"] == worker["thread"]
    assert by["worker.child"]["parent"] == by["worker"]["id"]
    assert by["worker.child"]["request"] == 3
    for s in by.values():
        assert s["t1_ns"] >= s["t0_ns"]
    assert by["outer"]["t0_ns"] <= by["inner"]["t0_ns"] <= by["inner"]["t1_ns"] \
        <= by["other"]["t0_ns"] <= by["outer"]["t1_ns"]


def test_self_time_on_hand_made_spans():
    rec = SpanRecorder()
    ms = 1_000_000
    # a: [0, 10) ms holding b [1, 4) and c [5, 6); b holds d [2, 3)
    for s in (("d", 2 * ms, 3 * ms, 4, 2, 1, 0), ("b", 1 * ms, 4 * ms, 2, 1, 1, 0),
              ("c", 5 * ms, 6 * ms, 3, 1, 1, 0), ("a", 0, 10 * ms, 1, None, 1, 0),
              ("a", 20 * ms, 22 * ms, 5, None, 1, 1)):
        rec._add(s)
    got = rec.summary()
    assert got["dropped"] == 0
    sp = got["spans"]
    assert sp["a"]["count"] == 2
    assert sp["a"]["total_ms"] == pytest.approx(12.0)
    assert sp["a"]["self_ms"] == pytest.approx((10.0 - 3.0 - 1.0) + 2.0)
    assert sp["a"]["max_ms"] == pytest.approx(10.0)
    assert sp["b"]["self_ms"] == pytest.approx(2.0)
    assert sp["d"]["self_ms"] == pytest.approx(1.0) == sp["c"]["self_ms"]
    # the window selects by start: a child counts against its parent
    # even where it starts outside the window
    got = rec.summary(1.5e-3, 21e-3)
    assert set(got["spans"]) == {"d", "c", "a"} and got["spans"]["a"]["count"] == 1
    assert got["spans"]["a"]["self_ms"] == pytest.approx(2.0)


def test_drops_are_counted_past_the_capacity():
    rec = SpanRecorder()
    rec.capacity = 5
    rec.enable()
    for _ in range(8):
        with rec.span("s"):
            pass
    got = rec.summary()
    assert got["spans"]["s"]["count"] == 5 and got["dropped"] == 3
    rec.clear()
    assert rec.summary() == {"dropped": 0, "spans": {}}


def test_nothing_is_recorded_while_off():
    rec = SpanRecorder()
    with rec.poll() as on:
        assert on is False
    with rec.span("a", 1):
        with rec.span("b"):
            pass
    rec.enable()
    rec.disable()
    with rec.span("c"):
        pass
    assert rec.spans() == [] and rec.summary()["spans"] == {}
    assert rec.span("d") is rec.span("e")   # off, a span is one shared no-op


def test_poll_holds_the_flag_for_one_unit_of_work():
    rec = SpanRecorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.poll() as on:
            assert on and rec.on and rec.profiling
            with rec.poll() as inner:
                assert inner
            assert rec.on and rec.profiling    # the enclosing unit's reading
        assert not rec.on and not rec.profiling
    rec.enable()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.poll():
            pass
    assert rec.on and not rec.profiling
    rec.disable()
    assert not rec.on


def _direct_step(srv):
    """One block through the server's runners (its step), outside its loop."""
    sig, ref, seq = srv._stage([srv.source.next_block()])
    srv._st, *_ = srv._runners.run(srv._st, sig, ref, True, seq)


def test_recording_ends_with_the_unit_of_work(spans):
    """A profiled run or offline call leaves nothing recording: a direct
    step, inside the profiler or after it, records no span."""
    srv = _server(1)
    srv.run(max_blocks=1)
    truth = make_truth(3, seed=2, max_delay=20.0, snr_db=30.0)
    cap = synth_capture(torch.Generator().manual_seed(2), truth, 4, L)
    with profile(activities=[ProfilerActivity.CPU]):
        assert srv.run(max_blocks=2) == 2
        align_offline(PipelineConfig(**FUSED), cap.sig_u8, cap.ref_u8)
        n = len(spans.spans())
        assert n > 0 and not spans.on and not spans.profiling
        _direct_step(srv)
    _direct_step(srv)
    assert len(spans.spans()) == n and not spans.on


def test_server_records_nothing_without_profiler_or_enable(spans):
    srv = _server(1)
    assert srv.run(max_blocks=3) == 3
    assert spans.spans() == [] and not spans.on


# ---- under torch.profiler ------------------------------------------------------

def test_spans_are_host_ops_of_the_profiler_on_its_clock(spans):
    """Each span of the loop's thread is a ``cpu_op`` (never a user
    annotation) of the profiler's trace, one event a span, starting within
    0.5 ms of the span's start mapped through the anchor; the publisher
    worker sees no profiler, and its spans are the recorder's alone."""
    srv = _server(1)
    srv.run(max_blocks=2)          # warm-up, unrecorded
    assert spans.spans() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        assert srv.run(max_blocks=4) == 4
    assert not spans.on
    mine = [s for s in spans.spans(t0) if s["thread"] == threading.get_ident()]
    worker = [s for s in spans.spans(t0) if s["thread"] != threading.get_ident()]
    assert {s["name"] for s in worker} == set(WORKER)
    names = {s["name"] for s in spans.spans()}
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events.setdefault(e.name(), []).append(e)
    assert set(events) == {s["name"] for s in mine} >= set(LOOP + STEP + KERNELS)
    for name, evs in events.items():
        ours = sorted((s for s in mine if s["name"] == name), key=lambda s: s["t0_ns"])
        evs.sort(key=lambda e: e.start_ns())
        assert len(evs) == len(ours), name
        for e, s in zip(evs, ours):
            assert not e.is_user_annotation()
            if hasattr(e, "activity_type"):      # not in torch 2.11
                assert e.activity_type() == "cpu_op"
            assert e.device_type() == torch.autograd.DeviceType.CPU
            assert abs(spans.to_unix_ns(s["t0_ns"]) - e.start_ns()) < 500_000, name


# ---- where the work happens ----------------------------------------------------

@pytest.mark.parametrize("depth,blocks", [(1, 6), (4, 12)])
def test_server_spans_per_block(spans, depth, blocks):
    srv = _server(depth)
    spans.enable()
    assert srv.run(max_blocks=blocks) == blocks
    spans.disable()
    by = _by_name(spans.spans())
    batches = blocks // depth
    for name in LOOP + WORKER:
        assert len(by[name]) == batches, name
    # on the CPU the worker has no copy to wait for
    assert "server.fetch_wait" not in by
    for name in STEP + KERNELS:
        assert len(by[name]) == blocks, name
    assert len(by["step.unpack"]) == len(by["step.pack"]) == batches
    main = threading.get_ident()
    ids = {s["id"]: s for s in spans.spans()}
    for name in LOOP[1:]:
        for s in by[name]:
            assert ids[s["parent"]]["name"] == "server.block" and s["thread"] == main
    for s in by["server.fetch"] + by["server.publish"]:
        assert ids[s["parent"]]["name"] == "server.publish_batch" and s["thread"] != main
    for name in STEP + ("step.unpack", "step.pack"):
        for s in by[name]:
            assert ids[s["parent"]]["name"] == "server.dispatch"
    for name in KERNELS:
        for s in by[name]:
            assert ids[s["parent"]]["name"] in ("step.measure", "step.apply")
    # the worker's spans carry the block indices of the loop's dispatches
    want = [depth * i for i in range(batches)]
    assert sorted(s["request"] for s in by["server.dispatch"]) == want
    assert sorted(s["request"] for s in by["server.block"]) == want
    for name in WORKER:
        assert sorted(s["request"] for s in by[name]) == want, name


def test_offline_call_spans(spans):
    truth = make_truth(3, seed=2, max_delay=20.0, snr_db=30.0)
    cap = synth_capture(torch.Generator().manual_seed(2), truth, 6, L)
    spans.enable()
    align_offline(PipelineConfig(**FUSED), cap.sig_u8, cap.ref_u8)
    align_offline(PipelineConfig(**FUSED), cap.sig_u8, cap.ref_u8)
    spans.disable()
    by = _by_name(spans.spans())
    calls = by["offline.align"]
    assert len(calls) == 2 and calls[1]["request"] == calls[0]["request"] + 1
    ids = {s["id"]: s for s in spans.spans()}
    for name in ("offline.xor", "offline.measure", "offline.smooth", "offline.apply"):
        assert len(by[name]) == 2, name
        for s in by[name]:
            assert ids[s["parent"]]["name"] == "offline.align"
    for s in by["kernels.measure_ref"] + by["kernels.measure_spec"]:
        assert ids[s["parent"]]["name"] == "offline.measure"
    assert ids[by["kernels.apply_spec_i8"][0]["parent"]]["name"] == "offline.apply"


# ---- the benchmark's readers ---------------------------------------------------

FLOOD_READERS = {
    "server.loop_self_ms_per_block.server_flood": 1.0,     # 4 - 3 ms of children, a block
    "server.stage_ms_per_block.server_flood": 0.5,
    "server.queue_wait_ms_per_block.server_flood": 0.25,
    "server.fetch_wait_ms_per_block.server_flood": 1.5,
    "server.publish_ms_per_block.server_flood": 0.75,
    "step.host_ms_per_block.server_flood": 2.0,
    "kernels.launch_host_ms_per_block.server_flood": 0.3,
}


def _fill_flood(rec, t0_s, blocks):
    """Per block, hand-made: server.block 4 ms holding stage 0.5, dispatch
    2 (holding kernels 0.1 + 0.2) and queue_wait 0.25 + control 0.25; the
    worker's publish_batch holding fetch 2 (fetch_wait 1.5) and publish
    0.75. One block before the window is never read."""
    us = 1000
    ids = iter(range(1, 10**6))
    for g in range(-1, blocks):
        t = int(t0_s * 1e9) + (g * 10_000 + 10) * us
        blk = next(ids)
        rec._add(("server.block", t, t + 4000 * us, blk, None, 1, g))
        rec._add(("server.stage", t, t + 500 * us, next(ids), blk, 1, g))
        disp = next(ids)
        rec._add(("server.dispatch", t + 500 * us, t + 2500 * us, disp, blk, 1, g))
        rec._add(("kernels.measure_ref", t + 600 * us, t + 700 * us, next(ids), disp, 1, g))
        rec._add(("kernels.apply_spec_i8", t + 800 * us, t + 1000 * us, next(ids), disp, 1, g))
        rec._add(("server.queue_wait", t + 2500 * us, t + 2750 * us, next(ids), blk, 1, g))
        rec._add(("server.control", t + 2750 * us, t + 3000 * us, next(ids), blk, 1, g))
        pb, fe = next(ids), next(ids)
        rec._add(("server.publish_batch", t + 3000 * us, t + 6000 * us, pb, None, 2, g))
        rec._add(("server.fetch", t + 3000 * us, t + 5000 * us, fe, pb, 2, g))
        rec._add(("server.fetch_wait", t + 3100 * us, t + 4600 * us, next(ids), fe, 2, g))
        rec._add(("server.publish", t + 5000 * us, t + 5750 * us, next(ids), pb, 2, g))


def test_flood_readers_on_hand_made_spans(spans):
    t0, blocks = 100.0, 20
    _fill_flood(spans, t0, blocks)
    run = types.SimpleNamespace(data=dict(t0=t0, blocks=blocks), trace=None, marks=[],
                                t_start=0.0)
    for name, want in FLOOD_READERS.items():
        assert harness.reader(name)(run) == pytest.approx(want), name
    assert harness.reader("offline.host_ms_per_call.offline")(run) is None
    # nothing read where a span was dropped, or where none was recorded
    spans.dropped = 1
    for name in FLOOD_READERS:
        assert harness.reader(name)(run) is None, name
    spans.clear()
    for name in FLOOD_READERS:
        assert harness.reader(name)(run) is None, name


def test_offline_reader_on_hand_made_spans(spans):
    # calls of 2 ms every 2.5 ms from the window's start (t_start + 5 s);
    # the window closes 1 s later and is marked 0.5 ms after that
    t_start, start = 50.0, 55.0
    for i in range(-2, 400):
        t = int((start + 2.5e-3 * i) * 1e9) + 20_000
        spans._add(("offline.align", t, t + 2_000_000, i + 10, None, 1, i))
    run = types.SimpleNamespace(data=dict(calls=400, wall_s=1.0), t_start=t_start,
                                marks=[("imports", 1.0), ("window end", 6.0005)])
    got = harness.reader("offline.host_ms_per_call.offline")(run)
    assert got == pytest.approx(2.0)
    assert harness.reader("step.host_ms_per_block.server_flood")(run) is None
    spans.dropped = 2
    assert harness.reader("offline.host_ms_per_call.offline")(run) is None


def test_every_span_reader_has_its_benchmark_entry():
    bench = harness.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in list(FLOOD_READERS) + ["offline.host_ms_per_call.offline"]:
        m = entries[name]
        assert m["source"] == "host_clock" and m["unit"] == "ms" and m["better"] == "lower"
        cells = ["b8192.offline", "b32768.offline"] if name.startswith("offline.") \
            else ["b8192.server_flood"]
        assert m["workloads"] == cells
        for c in cells:
            assert name in {p["name"] for p in harness.find_cell(bench, c).per_layer}
