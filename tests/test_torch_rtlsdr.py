"""The port's librtlsdr capture path against the mock librtlsdr
(tests/data/mock_librtlsdr.c, compiled here with gcc), after
tests/test_rtlsdr.py: the reference's order-sensitive open sequence
(sample rate -> dithering off -> centre frequency -> AGC -> gain mode /
gain -> zero correction), the ring block layout, runtime control,
``HwDriftRelief`` on the real actuator path, the USB inventory, per-channel
seqnums, hot-plug, the console reaching the dongles through ``RtlSource``
and the port's server, and ``--cpu --source rtlsdr`` end to end through the
port's app (frames read back by the port's client code).

The mock logs every ABI call to ``$MOCK_RTLSDR_LOG`` and streams a
deterministic per-device byte pattern (byte j of device idx is
idx * 37 + (j & 0x7f)) at ~500 blocks/s.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from coherent_rtlsdr_tpu_torch import native
from coherent_rtlsdr_tpu_torch.apps import coherent_server as app
from coherent_rtlsdr_tpu_torch.io import hwcontrol
from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig
from coherent_rtlsdr_tpu_torch.signal import make_truth
from coherent_rtlsdr_tpu_torch.signal.sources import (
    RingSource,
    RtlSource,
    SyntheticStreamSource,
)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MOCK_SRC = os.path.join(HERE, "data", "mock_librtlsdr.c")

L = 64  # complex samples a channel-block
CHAN_BYTES = 2 * L


class FakePub:
    def __init__(self):
        self.seqnums = []

    def publish(self, iq, seqnums, phases=None):
        self.seqnums.append(np.array(seqnums))
        return 0

    def close(self):
        pass


class FakeCtl:
    def poll(self, cb):
        pass

    def close(self):
        pass


@pytest.fixture(scope="module")
def mock_lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("mockrtl") / "libmock_rtlsdr.so")
    subprocess.run(["gcc", "-shared", "-fPIC", "-O2", "-o", so, MOCK_SRC], check=True,
                   timeout=60)
    assert native.rtlsdr_load(so), "mock librtlsdr failed to load"
    return so


@pytest.fixture()
def call_log(tmp_path, mock_lib, monkeypatch):
    log = str(tmp_path / "calls.log")
    monkeypatch.setenv("MOCK_RTLSDR_LOG", log)
    return log


def _parse(log):
    """-> [(devidx, fn, arg)] in call order."""
    if not os.path.exists(log):
        return []
    with open(log) as f:
        return [(int(i), fn, int(a)) for i, fn, a in (ln.split() for ln in f)]


def _calls_for(entries, idx):
    return [(fn, arg) for i, fn, arg in entries if i == idx]


def _pattern(idx, offset, n):
    j = np.arange(offset, offset + n, dtype=np.uint64)
    return ((idx * 37 + (j & 0x7F)) & 0xFF).astype(np.uint8)


def _pattern_ok(row, dev_idx, seq):
    """A channel row carries exactly its device's capture block ``seq``."""
    return np.array_equal(row, _pattern(dev_idx, (seq - 1) * CHAN_BYTES, CHAN_BYTES))


def _start(ring, serials, **kw):
    kw.setdefault("block_len", L)
    kw.setdefault("fs", 2.048e6)
    kw.setdefault("fcenter", 1024e6)
    return native.NativeRtlCapture(ring, serials, **kw)


def _wait(cond, seconds=10.0):
    deadline = time.time() + seconds
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


class TestEnumeration:
    def test_available_and_serials(self, mock_lib):
        assert native.rtlsdr_available()
        assert native.rtlsdr_enumerate() == ["MOCKREF0", "MOCK0001", "MOCK0002", "MOCK0003"]


class TestOpenSequence:
    def test_reference_open_order_per_device(self, call_log):
        ring = native.NativeBlockRing(64, 3 * CHAN_BYTES)
        cap = _start(ring, ["MOCKREF0", "MOCK0001", "MOCK0002"], gain_db=49.6, ref_gain_db=32.8)
        try:
            assert _wait(lambda: cap.pushed >= 2), "no blocks assembled"
            assert cap.error == 0
        finally:
            cap.stop()
        entries = _parse(call_log)
        expect = ["open", "set_sample_rate", "set_dithering", "set_center_freq", "set_agc_mode",
                  "set_tuner_gain_mode", "set_tuner_gain", "set_sample_freq_correction_f",
                  "reset_buffer", "read_async"]
        for idx in (0, 1, 2):
            calls = _calls_for(entries, idx)
            fns = [fn for fn, _ in calls]
            assert [f for f in fns if f in set(expect)][: len(expect)] == expect, (idx, fns)
            args = dict(calls)
            assert args["set_sample_rate"] == 2048000
            assert args["set_center_freq"] == 1024000000
            assert args["set_tuner_gain_mode"] == 1
            assert args["set_tuner_gain"] == (328 if idx == 0 else 496)
            assert args["set_sample_freq_correction_f"] == 0

    def test_capture_stop_cancels_and_closes(self, call_log):
        ring = native.NativeBlockRing(64, 2 * CHAN_BYTES)
        cap = _start(ring, ["MOCKREF0", "MOCK0003"])
        _wait(lambda: cap.pushed >= 1)
        cap.stop()
        assert not cap.running
        entries = _parse(call_log)
        for idx in (0, 3):
            fns = [fn for fn, _ in _calls_for(entries, idx)]
            assert "cancel_async" in fns and fns.index("cancel_async") < fns.index("close")


class TestAssembledBlocks:
    def test_ring_block_layout_ref_first(self, call_log):
        serials = ["MOCKREF0", "MOCK0002", "MOCK0001"]   # deliberate disorder
        ring = native.NativeBlockRing(64, 3 * CHAN_BYTES)
        cap = _start(ring, serials)
        try:
            buf, seq, _ = ring.pop(timeout_ms=10000)
            assert seq == 1 and cap.dropped == 0
            frame = buf.reshape(3, CHAN_BYTES)
            for slot, serial in enumerate(serials):
                idx = int(serial[-1]) if serial[-1].isdigit() else 0
                np.testing.assert_array_equal(frame[slot], _pattern(idx, 0, CHAN_BYTES))
            assert ring.pop(timeout_ms=10000)[1] == 2
        finally:
            cap.stop()

    def test_ring_source_consumes_capture(self, call_log):
        ring = native.NativeBlockRing(64, 3 * CHAN_BYTES)
        cap = _start(ring, ["MOCKREF0", "MOCK0001", "MOCK0002"])
        try:
            sig, ref, seqs = RingSource(ring, n_channels=2, block_len=L,
                                        timeout_ms=10000).next_block()
            assert sig.shape == (2, L, 2) and ref.shape == (L, 2) and sig.dtype == np.uint8
            assert (seqs > 0).all()
        finally:
            cap.stop()


class TestRuntimeControl:
    def test_retune_disables_dithering_first(self, call_log):
        ring = native.NativeBlockRing(64, 2 * CHAN_BYTES)
        cap = _start(ring, ["MOCKREF0", "MOCK0001"])
        try:
            _wait(lambda: cap.pushed >= 1)
            mark = len(_parse(call_log))
            assert cap.set_fcenter(868e6) == 0
            entries = _parse(call_log)[mark:]
            for idx in (0, 1):
                fns = [fn for fn, _ in _calls_for(entries, idx)]
                assert fns.index("set_dithering") < fns.index("set_center_freq")
                assert dict(_calls_for(entries, idx))["set_center_freq"] == 868000000
        finally:
            cap.stop()

    def test_set_correction_targets_one_device(self, call_log):
        ring = native.NativeBlockRing(64, 3 * CHAN_BYTES)
        cap = _start(ring, ["MOCKREF0", "MOCK0001", "MOCK0002"])
        try:
            _wait(lambda: cap.pushed >= 1)
            mark = len(_parse(call_log))
            assert cap.set_correction_f(2, 3.5e-4) == 0
            hits = [(i, a) for i, fn, a in _parse(call_log)[mark:]
                    if fn == "set_sample_freq_correction_f"]
            assert hits == [(2, 350000)]   # 3.5e-4 in nano-units
        finally:
            cap.stop()


class FakeCap:
    def __init__(self):
        self.calls = []

    def set_correction_f(self, ch, p):
        self.calls.append((ch, p))
        return 0


class TestHwDriftRelief:
    def test_tanh_pulse_and_deadline_restore(self):
        cap = FakeCap()
        r = hwcontrol.HwDriftRelief(cap, fs=2.048e6, threshold=8.0)
        assert r.tick([0.0, 5.0, -7.9], now=0.0) == 0 and cap.calls == []
        assert r.tick([0.0, 50.0, 0.0], now=0.0) == 1
        (ch, p), = cap.calls
        expect = hwcontrol.MAX_CORR * np.tanh(50.0 / hwcontrol.SCALE)
        assert ch == 2 and abs(p - expect) < 1e-9 and r.active == [1]
        dwell = hwcontrol.FRAC_T * abs(50.0 / (expect * 2.048e6))
        assert r.tick([0.0, 50.0, 0.0], now=dwell * 0.5) == 0   # mid-dwell
        assert r.tick([0.0, 1.0, 0.0], now=dwell + 1e-3) == 1
        assert cap.calls[-1] == (2, 0.0) and r.active == []
        assert r.pulses == 1 and r.failures == 0

    def test_negative_delay_negative_correction_and_stop(self):
        cap = FakeCap()
        r = hwcontrol.HwDriftRelief(cap, fs=1e6, threshold=8.0)
        r.tick([-40.0], now=0.0)
        assert cap.calls[0][0] == 1 and cap.calls[0][1] < 0
        r.stop()
        assert cap.calls[-1] == (1, 0.0) and r.active == []

    def test_actuates_real_capture_path(self, call_log):
        ring = native.NativeBlockRing(64, 3 * CHAN_BYTES)
        cap = _start(ring, ["MOCKREF0", "MOCK0001", "MOCK0002"])
        try:
            _wait(lambda: cap.pushed >= 1)
            mark = len(_parse(call_log))
            r = hwcontrol.HwDriftRelief(cap, fs=2.048e6, threshold=8.0)
            r.tick([0.0, 100.0], now=0.0)   # signal ch 1 -> dongle MOCK0002
            r.tick([0.0, 0.0], now=1e9)     # past the deadline: restore
            hits = [(i, a) for i, fn, a in _parse(call_log)[mark:]
                    if fn == "set_sample_freq_correction_f"]
            expect = hwcontrol.MAX_CORR * np.tanh(1.0)
            assert len(hits) == 2 and hits[0][0] == 2
            assert abs(hits[0][1] - expect * 1e9) < 1e3 and hits[1] == (2, 0)
        finally:
            cap.stop()

    def test_server_ticks_and_restores_on_exit(self, call_log):
        """The port's server ticks the relief from its loop with the applied
        delays (at most 4 Hz) and restores every skewed dongle on exit."""
        src = RtlSource.start(["MOCKREF0", "MOCK0001", "MOCK0002"], block_len=L, ring_slots=256,
                              fs=2.048e6, fcenter=1024e6, timeout_ms=10000)
        srv = CoherentServer(PipelineConfig(n_channels=2, block_len=L), src, publisher=FakePub(),
                             control=FakeCtl(), device="cpu")
        relief = hwcontrol.HwDriftRelief(src.capture, fs=2.048e6, threshold=8.0)
        ticks = []
        tick = relief.tick
        relief.tick = lambda delays, now=None: ticks.append(np.array(delays)) or tick(delays, now)
        srv.hw_relief = relief
        try:
            # The capture threads open the dongles after start returns: a tick
            # before the first block would find no dongle to set.
            assert _wait(lambda: src.capture.pushed >= 1)
            relief.tick([0.0, 100.0])   # dongle 2 mid-dwell when the loop starts
            mark = len(_parse(call_log)) - 1
            assert srv.run(max_blocks=8) == 8
        finally:
            src.stop()
        assert len(ticks) >= 2 and all(t.shape == (2,) for t in ticks[1:])
        hits = [(i, a) for i, fn, a in _parse(call_log)[mark:]
                if fn == "set_sample_freq_correction_f"]
        assert hits[0][0] == 2 and hits[0][1] > 0 and (2, 0) in hits[1:]
        assert relief.active == []


class TestConsoleInventory:
    def test_list_all_shows_usb_inventory(self, mock_lib):
        truth = make_truth(2, seed=0, max_delay=10.0, snr_db=30.0)
        srv = CoherentServer(PipelineConfig(n_channels=2, block_len=256),
                             SyntheticStreamSource(truth, block_len=256, seed=0, device="cpu"),
                             publisher=FakePub(), control=FakeCtl(), device="cpu")
        out = srv.list_channels(all=True)
        assert "USB inventory (4 dongles)" in out
        assert "'MOCKREF0'" in out and "'MOCK0003'" in out


class TestPerChannelSeqnums:
    def test_fast_device_gaps_only_its_channel(self, call_log, monkeypatch):
        monkeypatch.setenv("MOCK_RTLSDR_FAST", "2")   # MOCK0002 streams 10x faster
        # Every dongle gets the same FIFO of 2 * asyncbufn channel-blocks. At 2
        # (4 blocks, 8 ms at 500 blocks/s) the two slow dongles' threads drift
        # apart by more than that under CPU contention, and the leading one's
        # FIFO overflows too: a gap on channel 0 or 1. The default 8 (16
        # blocks, 32 ms) absorbs that drift, and the fast dongle, 9 blocks
        # ahead every frame, still overflows within a few frames. 256 ring
        # slots (0.5 s) keep a starved consumer from gapping every channel.
        ring = native.NativeBlockRing(256, 3 * CHAN_BYTES, n_seq=3)
        cap = _start(ring, ["MOCKREF0", "MOCK0001", "MOCK0002"], asyncbufn=8)
        frames = []
        try:
            deadline = time.time() + 60
            while time.time() < deadline:
                out = ring.pop_n(timeout_ms=5000)
                if out is not None:
                    frames.append(out)
                if len(frames) >= 40 and any(int(b[1][2]) - int(a[1][2]) > 1
                                             for a, b in zip(frames, frames[1:])):
                    break
        finally:
            dropped = cap.dropped
            cap.stop()
        assert len(frames) >= 40
        seqs = np.array([f[1] for f in frames])
        for t in (0, 1):
            assert (np.diff(seqs[:, t]) == 1).all(), seqs[:, t]
        d2 = np.diff(seqs[:, 2].astype(np.int64))
        assert (d2 >= 1).all() and (d2 > 1).any() and dropped > 0
        for buf, s, _ in frames:
            frame = buf.reshape(3, CHAN_BYTES)
            for slot in (0, 1, 2):
                assert _pattern_ok(frame[slot], slot, int(s[slot])), (slot, int(s[slot]))

    def test_stalled_device_never_skews_others(self, call_log, monkeypatch):
        monkeypatch.setenv("MOCK_RTLSDR_STALL", "1")   # MOCK0001 stalls 500 ms at block 6
        ring = native.NativeBlockRing(256, 3 * CHAN_BYTES, n_seq=3)
        cap = _start(ring, ["MOCKREF0", "MOCK0001", "MOCK0002"])
        frames = []
        try:
            deadline = time.time() + 30
            while len(frames) < 30 and time.time() < deadline:
                out = ring.pop_n(timeout_ms=5000)
                if out is not None:
                    frames.append(out)
            stalls = cap.stalls
        finally:
            cap.stop()
        assert len(frames) >= 30 and stalls >= 1
        for buf, s, _ in frames:
            frame = buf.reshape(3, CHAN_BYTES)
            for slot in (0, 1, 2):
                assert _pattern_ok(frame[slot], slot, int(s[slot])), (slot, int(s[slot]))
        assert (np.diff(np.array([f[1] for f in frames]).astype(np.int64), axis=0) >= 1).all()

    def test_usb_death_reports_not_running(self, call_log, monkeypatch):
        monkeypatch.setenv("MOCK_RTLSDR_DIE_AFTER", "3")
        ring = native.NativeBlockRing(64, 2 * CHAN_BYTES, n_seq=2)
        cap = _start(ring, ["MOCKREF0", "MOCK0001"])
        try:
            assert _wait(lambda: not cap.running), "a dead capture still reports running"
        finally:
            cap.stop()


class TestHotPlug:
    def test_set_fs_reaches_all_dongles(self, call_log):
        ring = native.NativeBlockRing(64, 2 * CHAN_BYTES, n_seq=2)
        cap = _start(ring, ["MOCKREF0", "MOCK0001"])
        try:
            _wait(lambda: cap.pushed >= 1)
            mark = len(_parse(call_log))
            assert cap.set_fs(1.024e6) == 0
            entries = _parse(call_log)[mark:]
            for idx in (0, 1):
                assert dict(_calls_for(entries, idx))["set_sample_rate"] == 1024000
        finally:
            cap.stop()

    def test_hot_add_streams_and_remove_shifts(self, call_log):
        ring = native.NativeBlockRing(64, 4 * CHAN_BYTES, n_seq=4)
        cap = _start(ring, ["MOCKREF0", "MOCK0001"])
        try:
            buf, seqs, _ = ring.pop_n(timeout_ms=10000)
            frame = buf.reshape(4, CHAN_BYTES)
            assert (frame[2] == 0x80).all() and (frame[3] == 0x80).all()
            assert seqs[2] == 0 and seqs[3] == 0
            assert cap.add("MOCK0002", gain_db=21.0) == 2
            assert cap.capture_serials() == ["MOCKREF0", "MOCK0001", "MOCK0002"]
            entries = _parse(call_log)
            fns = [fn for fn, _ in _calls_for(entries, 2)]
            assert fns.index("set_dithering") < fns.index("set_center_freq")
            assert dict(_calls_for(entries, 2))["set_tuner_gain"] == 210
            got = None
            deadline = time.time() + 10
            while got is None and time.time() < deadline:
                out = ring.pop_n(timeout_ms=5000)
                if out is not None and out[1][2] >= 1:
                    got = (out[0].reshape(4, CHAN_BYTES), out[1])
            assert got is not None, "the hot-added channel never streamed"
            assert _pattern_ok(got[0][2], 2, int(got[1][2]))
            mark = len(_parse(call_log))
            assert cap.remove("MOCK0001") == 1
            assert cap.capture_serials() == ["MOCKREF0", "MOCK0002"]
            fns = [fn for fn, _ in _calls_for(_parse(call_log)[mark:], 1)]
            assert "cancel_async" in fns and "close" in fns
            shifted = False
            deadline = time.time() + 10
            while not shifted and time.time() < deadline:
                out = ring.pop_n(timeout_ms=5000)
                if out is not None:
                    frame = out[0].reshape(4, CHAN_BYTES)
                    if _pattern_ok(frame[1], 2, int(out[1][1])):
                        shifted = True   # MOCK0002 now in slot 1
                        assert (frame[2] == 0x80).all()
            assert shifted
        finally:
            cap.stop()

    def test_add_unknown_serial_fails_cleanly(self, call_log):
        ring = native.NativeBlockRing(64, 3 * CHAN_BYTES, n_seq=3)
        cap = _start(ring, ["MOCKREF0", "MOCK0001"])
        try:
            _wait(lambda: cap.pushed >= 1)
            assert cap.add("NO_SUCH") < 0
            assert cap.capture_serials() == ["MOCKREF0", "MOCK0001"]
            before = cap.pushed
            assert _wait(lambda: cap.pushed > before)   # still streaming
        finally:
            cap.stop()


class TestConsoleToHardware:
    """Console mutations reach the dongles through RtlSource and the
    port's server."""

    @pytest.fixture()
    def server(self, call_log):
        src = RtlSource.start(["MOCKREF0", "MOCK0001", "MOCK0002"], block_len=L, max_channels=3,
                              fs=2.048e6, fcenter=1024e6)
        srv = CoherentServer(PipelineConfig(n_channels=2, block_len=L), src, publisher=FakePub(),
                             control=FakeCtl(), max_channels=3, device="cpu")
        _wait(lambda: src.capture.pushed >= 1)
        yield srv
        src.stop()

    def test_remote_fcenter_retunes_every_dongle(self, server, call_log):
        mark = len(_parse(call_log))
        assert server.dispatcher.dispatch("fcenter 868000000") == "fcenter set to 868000000"
        assert server.fcenter == 868000000
        entries = _parse(call_log)[mark:]
        for idx in (0, 1, 2):
            fns = [fn for fn, _ in _calls_for(entries, idx)]
            assert fns.index("set_dithering") < fns.index("set_center_freq")
            assert dict(_calls_for(entries, idx))["set_center_freq"] == 868000000

    def test_remote_fs_sets_rate_and_resyncs(self, server, call_log):
        mark = len(_parse(call_log))
        assert server.dispatcher.dispatch("fs 1024000") == "fs set to 1024000"
        entries = _parse(call_log)[mark:]
        for idx in (0, 1, 2):
            assert dict(_calls_for(entries, idx))["set_sample_rate"] == 1024000
        assert server._resync_requested and server.fs == 1024000

    def test_remote_add_del_hotplug_real_dongles(self, server, call_log):
        mark = len(_parse(call_log))
        assert server.dispatcher.dispatch("add MOCK0003") == "added 'MOCK0003' as channel 3"
        assert server.n_active == 3
        assert server.source.serials == ["MOCK0001", "MOCK0002", "MOCK0003"]
        fns = [fn for fn, _ in _calls_for(_parse(call_log)[mark:], 3)]
        assert "open" in fns and "read_async" in fns
        assert fns.index("set_dithering") < fns.index("set_center_freq")
        mark = len(_parse(call_log))
        assert server.dispatcher.dispatch("del MOCK0001") == "deleted 'MOCK0001'"
        assert server.n_active == 2 and server.source.serials == ["MOCK0002", "MOCK0003"]
        fns = [fn for fn, _ in _calls_for(_parse(call_log)[mark:], 1)]
        assert "cancel_async" in fns and "close" in fns

    def test_status_shows_capture_health(self, server, call_log):
        out = server.dispatcher.dispatch("status")
        assert "capture: RUNNING" in out and "chan-drops" in out and "stalls" in out

    def test_del_reference_refused(self, server, call_log):
        assert "no such channel" in server.dispatcher.dispatch("del MOCKREF0")
        assert server.source.capture.capture_serials()[0] == "MOCKREF0"

    def test_add_bad_serial_reports_failure(self, server, call_log):
        assert "failed" in server.dispatcher.dispatch("add GHOST")
        assert server.n_active == 2

    def test_add_duplicate_serial_refused_keeps_capture_alive(self, server, call_log):
        assert "failed" in server.dispatcher.dispatch("add MOCK0001")
        cap = server.source.capture
        assert server.n_active == 2
        assert cap.capture_serials() == ["MOCKREF0", "MOCK0001", "MOCK0002"]
        before = cap.pushed
        assert _wait(lambda: cap.pushed > before), "capture stalled after the duplicate add"

    def test_fs_failure_reports_and_restores(self, server, call_log, monkeypatch):
        monkeypatch.setenv("MOCK_RTLSDR_FAIL_FS", "1")   # MOCK0001 refuses
        mark = len(_parse(call_log))
        out = server.dispatcher.dispatch("fs 1024000")
        assert "FAILED" in out and "2048000" in out and server.fs == 2.048e6
        entries = _parse(call_log)[mark:]
        for idx in (0, 2):
            rates = [a for fn, a in _calls_for(entries, idx) if fn == "set_sample_rate"]
            assert rates == [1024000, 2048000], (idx, rates)

    def test_fcenter_failure_reports_and_restores(self, server, call_log, monkeypatch):
        monkeypatch.setenv("MOCK_RTLSDR_FAIL_TUNE", "2")
        mark = len(_parse(call_log))
        assert "FAILED" in server.dispatcher.dispatch("fcenter 868000000")
        assert server.fcenter == 1024e6
        entries = _parse(call_log)[mark:]
        for idx in (0, 1):
            tunes = [a for fn, a in _calls_for(entries, idx) if fn == "set_center_freq"]
            assert tunes == [868000000, 1024000000], (idx, tunes)

    def test_add_explicit_zero_gain_reaches_dongle(self, server, call_log):
        mark = len(_parse(call_log))
        assert server.source.capture.add("MOCK0003", gain_db=0.0) == 3
        assert dict(_calls_for(_parse(call_log)[mark:], 3))["set_tuner_gain"] == 0
        assert server.source.capture.remove("MOCK0003") == 3


class TestPerChannelGapsThroughPipeline:
    def test_one_dongle_drop_desyncs_only_that_channel(self, call_log, monkeypatch):
        """A single dongle's FIFO overflow (the 10x-fast mock device) gaps
        exactly that channel inside the port's pipeline."""
        monkeypatch.setenv("MOCK_RTLSDR_FAST", "2")   # MOCK0002 = signal ch 1
        # 8 s of the mock's frames: a slow CPU loop must not overflow the
        # ring, which would gap every channel at once
        src = RtlSource.start(["MOCKREF0", "MOCK0001", "MOCK0002"], block_len=L,
                              ring_slots=4096, fs=2.048e6, fcenter=1024e6, timeout_ms=10000)
        pub = FakePub()
        srv = CoherentServer(PipelineConfig(n_channels=2, block_len=L), src, publisher=pub,
                             control=FakeCtl(), device="cpu")
        try:
            assert srv.run(max_blocks=60) == 60
        finally:
            src.stop()
        gaps = srv.state.gaps
        assert gaps[1] >= 1, "the fast dongle's drops never gapped ch 1"
        assert gaps[0] == 0, "the healthy channel was gapped"
        seqs = np.stack(pub.seqnums).astype(np.int64)   # [T, 3]: ref, ch 0, ch 1
        assert (np.diff(seqs[:, 1]) == 1).all() and (np.diff(seqs[:, 2]) > 1).any()
        assert src._ring.dropped == 0


class TestFailurePaths:
    def test_unknown_serial_aborts_with_error(self, call_log):
        ring = native.NativeBlockRing(64, 2 * CHAN_BYTES)
        cap = _start(ring, ["MOCKREF0", "NO_SUCH_SERIAL"])
        try:
            assert _wait(lambda: not cap.running)
            assert cap.error != 0 and cap.pushed == 0
        finally:
            cap.stop()

    def test_bad_ring_geometry_rejected(self, call_log):
        ring = native.NativeBlockRing(64, 5 * CHAN_BYTES)   # 5 != 2 serials
        with pytest.raises(RuntimeError):
            _start(ring, ["MOCKREF0", "MOCK0001"])


def _addrs(tag):
    base = f"ipc://@crt-rtl-{os.getpid()}-{tag}"
    return ["-A", base + "-data", "--ctrl-address", base + "-ctrl", "--debug-address",
            base + "-debug"]


class TestServerApp:
    """The port's app with ``--cpu --source rtlsdr`` on the mock."""

    def test_app_source_rtlsdr_publishes_frames(self, mock_lib, tmp_path):
        """End to end in its own process: mock dongles -> native capture ->
        ring -> the port's pipeline on the CPU -> the native publisher ->
        frames that the port's client parses."""
        zmq = pytest.importorskip("zmq")
        from coherent_rtlsdr_tpu_torch.io.client import CoherentClient

        addrs = _addrs("e2e")
        env = dict(os.environ, COHERENT_LIBRTLSDR=mock_lib)
        env.pop("MOCK_RTLSDR_LOG", None)
        errf = open(tmp_path / "server.err", "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "coherent_rtlsdr_tpu_torch.apps.coherent_server", "--cpu",
             "--source", "rtlsdr", "--rtl-lib", mock_lib, "--serials",
             "MOCKREF0,MOCK0001,MOCK0002", "-n", "2", "-b", "256", "--blocks", "100000",
             "--ring-slots", "256", "--hw-drift-relief", "8", *addrs],
            stdout=subprocess.PIPE, stderr=errf, text=True, cwd=REPO, env=env)
        client = CoherentClient(data_addr=addrs[1], ctrl_addr=addrs[3], timeout_ms=1000,
                                max_retries=1)
        got, status = [], ""
        try:
            deadline = time.time() + 90
            while len(got) < 3 and time.time() < deadline and proc.poll() is None:
                f = client.read()
                if f is not None:
                    got.append(f)
            status = client.status()
        finally:
            client.close()
            proc.terminate()
            try:
                out = proc.communicate(timeout=60)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                out = proc.communicate()[0]
            errf.seek(0)
            err = errf.read()
            errf.close()
        assert len(got) == 3, (out[-1500:], err[-1500:])
        for f in got:
            assert f.x.shape == (3, 256) and f.seqnums.shape == (3,)
        assert [f.globalseqn for f in got] == list(range(got[0].globalseqn,
                                                         got[0].globalseqn + 3))
        assert "synchronized" in status and "capture: RUNNING" in status
        assert "published" in out and proc.returncode == 0

    def test_refserial_flag_reorders_and_sets_ref_gain(self, call_log, capsys):
        """-I picks the reference dongle: that serial becomes channel 0 and
        gets the -r gain, the others -g."""
        assert app.main(["--cpu", "--source", "rtlsdr", "--serials", "MOCKREF0,MOCK0001,MOCK0002",
                         "-I", "MOCK0001", "-g", "40", "-r", "30", "-n", "2", "-b", "256",
                         "--blocks", "4", "--ring-slots", "64", *_addrs("refserial")]) == 0
        assert "published 4 frames" in capsys.readouterr().out
        gains = {i: a for i, fn, a in _parse(call_log) if fn == "set_tuner_gain"}
        assert gains == {1: 300, 0: 400, 2: 400}
        fns = [fn for _, fn, _ in _parse(call_log)]
        assert fns.count("close") == 3   # the app stopped the capture

    def test_config_per_channel_gains_reach_dongles(self, call_log, tmp_path, capsys):
        cfgf = tmp_path / "arr.cfg"
        cfgf.write_text("R :'MOCKREF0' gain=32.5\n1 :'MOCK0001'\n2 :'MOCK0002' gain=21\n")
        assert app.main(["--cpu", "--source", "rtlsdr", "-C", str(cfgf), "-g", "44", "-r", "33",
                         "-b", "256", "--blocks", "4", "--ring-slots", "64",
                         *_addrs("config")]) == 0
        assert "published 4 frames" in capsys.readouterr().out
        gains = {i: a for i, fn, a in _parse(call_log) if fn == "set_tuner_gain"}
        assert gains == {0: 325, 1: 440, 2: 210}

    def test_hw_drift_relief_needs_rtlsdr(self):
        with pytest.raises(SystemExit):
            app.main(["--cpu", "--hw-drift-relief", "8"])
