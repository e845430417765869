"""The port's streaming server (CPU): against the JAX package's
``CoherentServer`` on the same capture, checkpoints across the two, the
port's own loop (console, gaps, hot-plug, the pipelined publisher), one
ZMQ roundtrip read by the JAX package's client, and the app.

Bars against the JAX server on one ``FileSource`` capture: the same frame
count and seqnums, wire bytes within 1 LSB (the step's own bar,
tests/test_torch_pipeline.py, where under 1e-3 of the bytes may differ by
more), phases within 1e-4, and the same "N / N synchronized" line. The
port-internal cases mirror tests/test_server.py with its bars.
"""

import dataclasses
import inspect
import os
import threading
import time

import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.io.server import CoherentServer as JaxServer
from coherent_rtlsdr_tpu.io.streamio import Capture
from coherent_rtlsdr_tpu.pipeline import PipelineConfig as JaxConfig
from coherent_rtlsdr_tpu.signal.sources import FileSource as JaxFileSource
from coherent_rtlsdr_tpu_torch.apps import coherent_server as app
from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
from coherent_rtlsdr_tpu_torch.io.streamio import detect_seqnum_gaps
from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig
from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_capture
from coherent_rtlsdr_tpu_torch.signal.sources import FileSource, SyntheticStreamSource

L = 1024
WIRE_LSB = 1
PHASE_ATOL = 1e-4


class FakePublisher:
    def __init__(self):
        self.frames = []

    def publish(self, iq_i8, seqnums, phases=None):
        self.frames.append((np.array(iq_i8), np.array(seqnums),
                            None if phases is None else np.array(phases)))
        return iq_i8.size


class FakeControl:
    def __init__(self):
        self.queue = []

    def poll(self, handler, timeout_ms=0):
        n = 0
        while self.queue:
            handler(self.queue.pop(0))
            n += 1
        return n


def _server(n=3, state_path=None, drop_rate=0.0, seed=0, source=None, **kw):
    truth = make_truth(n, seed=seed, max_delay=20.0, snr_db=30.0)
    src = source or SyntheticStreamSource(truth, block_len=L, slab_blocks=8, seed=seed,
                                          drop_rate=drop_rate, device="cpu")
    pub, ctl = FakePublisher(), FakeControl()
    srv = CoherentServer(PipelineConfig(n_channels=n, block_len=L), src, publisher=pub,
                         control=ctl, state_path=state_path, device="cpu", **kw)
    return srv, pub, ctl, truth


# ---- against the JAX server ------------------------------------------------

def _capture(impl_L, T, n=3, seed=4):
    truth = make_truth(n, seed=seed, max_delay=20.0, snr_db=30.0)
    cap = synth_capture(torch.Generator().manual_seed(seed), truth, T, impl_L)
    seqs = np.tile(np.arange(1, T + 1, dtype=np.uint32)[:, None], (1, n))
    return Capture(sig_u8=cap.sig_u8.numpy(), ref_u8=cap.ref_u8.numpy(), seqnums=seqs,
                   fs=2.048e6, fcenter=868e6)


def _configs(impl, block_len, n=3):
    kw = dict(n_channels=n, block_len=block_len, fft_impl=impl,
              lag_method="phase_zoom" if impl == "fused" else "phase_slope")
    return JaxConfig(**kw), PipelineConfig(**kw)


def _assert_same_frames(jframes, tframes):
    assert len(jframes) == len(tframes) > 0
    for (jiq, jseq, jph), (tiq, tseq, tph) in zip(jframes, tframes):
        assert tiq.shape == jiq.shape and tiq.dtype == jiq.dtype == np.int8
        np.testing.assert_array_equal(tseq, jseq)
        assert np.abs(tiq.astype(np.int16) - jiq.astype(np.int16)).max() <= WIRE_LSB
        np.testing.assert_allclose(tph, jph, rtol=0, atol=PHASE_ATOL)


def _with_gaps(cap):
    """The capture with seqnum gaps: channel 1 skips one capture block
    after block 4, channel 2 two blocks after block 7."""
    seqs = cap.seqnums.copy()
    seqs[5:, 1] += 1
    seqs[8:, 2] += 2
    return dataclasses.replace(cap, seqnums=seqs)


def _assert_same_server_state(jsrv, tsrv):
    js, ts = jsrv.state, tsrv.state
    np.testing.assert_allclose(ts.delay, np.asarray(js.delay), atol=2e-3)
    np.testing.assert_array_equal(ts.gaps, np.asarray(js.gaps))
    np.testing.assert_array_equal(ts.last_seq, np.asarray(js.last_seq))
    np.testing.assert_array_equal(ts.synced, np.asarray(js.synced))


# (impl, scan_depth, max_channels, seqnum gaps, block length, blocks): the
# fused, pallas and mxu paths at L = 2048 (W = 64^2, their smallest square
# length), xla at L = 1024, and the fused path at L = 32768 (W = 256^2, its
# largest; 8 blocks keep the JAX kernels' interpret mode short).
SERVER_CASES = [
    pytest.param("fused", 1, None, False, 2048, 12, id="fused-1"),
    pytest.param("fused", 4, None, False, 2048, 12, id="fused-4"),
    pytest.param("xla", 1, None, False, L, 12, id="xla-1"),
    pytest.param("xla", 4, None, False, L, 12, id="xla-4"),
    pytest.param("xla", 1, 5, False, L, 12, id="xla-1-padded"),
    pytest.param("xla", 4, 5, True, L, 12, id="xla-4-padded-gaps"),
    pytest.param("fused", 4, 5, True, 2048, 12, id="fused-4-padded-gaps"),
    pytest.param("pallas", 4, None, False, 2048, 12, id="pallas-4"),
    pytest.param("mxu", 1, None, True, 2048, 12, id="mxu-1-gaps"),
    pytest.param("fused", 2, None, False, 32768, 8, id="fused-2-L32768"),
    pytest.param("pallas", 2, None, False, 32768, 8, id="pallas-2-L32768"),
]


@pytest.mark.parametrize("impl, scan_depth, max_channels, gaps, block_len, n_blocks",
                         SERVER_CASES)
def test_matches_jax_server(impl, scan_depth, max_channels, gaps, block_len, n_blocks):
    """Both servers on one FileSource capture (12 blocks, or 8 at L = 32768;
    3 channels): the same frames, seqnums and phases, the same per-channel
    gaps, last seqnums and sync flags, and the same status line (every
    channel synchronized where no seqnum jumps)."""
    cap = _capture(block_len, n_blocks)
    if gaps:
        cap = _with_gaps(cap)
    jcfg, tcfg = _configs(impl, block_len)
    jpub, tpub = FakePublisher(), FakePublisher()
    kw = dict(control=FakeControl(), scan_depth=scan_depth, max_channels=max_channels)
    jsrv = JaxServer(jcfg, JaxFileSource(cap), publisher=jpub, **kw)
    tsrv = CoherentServer(tcfg, FileSource(cap), publisher=tpub, device="cpu", **kw)
    assert jsrv.run() == tsrv.run() == n_blocks
    _assert_same_frames(jpub.frames, tpub.frames)
    jline, tline = jsrv.status().splitlines()[0], tsrv.status().splitlines()[0]
    assert jline == tline
    if not gaps:
        assert tline == "3 / 3 synchronized"
    _assert_same_server_state(jsrv, tsrv)
    assert tsrv.state.gaps.sum() == (2 if gaps else 0)   # one event a jump


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_restores_across_the_two_servers(tmp_path, direction):
    """A calibration checkpoint written by one server restores in the
    other, which resumes synced (no re-acquisition) on the same bytes as
    the writer's own continuation."""
    cap = _capture(L, 16, seed=9)
    first = Capture(sig_u8=cap.sig_u8[:8], ref_u8=cap.ref_u8[:8], seqnums=cap.seqnums[:8],
                    fs=cap.fs, fcenter=cap.fcenter)
    # a restarted capture counts its seqnums from 1 again
    rest = Capture(sig_u8=cap.sig_u8[8:], ref_u8=cap.ref_u8[8:], seqnums=cap.seqnums[:8],
                   fs=cap.fs, fcenter=cap.fcenter)
    path = str(tmp_path / "cal.npz")
    jcfg, tcfg = _configs("xla", L)
    make_j = lambda c, p: JaxServer(jcfg, JaxFileSource(c), publisher=p, control=FakeControl(),
                                    state_path=path)
    make_t = lambda c, p: CoherentServer(tcfg, FileSource(c), publisher=p,
                                         control=FakeControl(), state_path=path, device="cpu")
    writer, reader = (make_j, make_t) if direction == "jax_to_port" else (make_t, make_j)
    w = writer(first, FakePublisher())
    w.fcenter = 433e6
    w.run()
    saved = np.load(path)
    r = reader(rest, FakePublisher())
    st = r.state
    np.testing.assert_array_equal(np.asarray(st.delay), saved["delay"])
    np.testing.assert_array_equal(np.asarray(st.phase), saved["phase_iq"])
    assert np.asarray(st.synced).all() and int(np.asarray(st.block_idx)) == 8
    assert r.fcenter == 433e6 and r.fs == 2.048e6
    r.run(max_blocks=1)
    assert np.asarray(r.state.synced).all()   # the first block after the restore
    assert int(r.publisher.frames[0][1][0]) == 9   # ref seqnums continue


# ---- the port's own loop (tests/test_server.py) ----------------------------

class TestServerLoop:
    def test_publishes_frames_with_ref_channel(self):
        srv, pub, _, _ = _server()
        srv.run(max_blocks=6)
        assert len(pub.frames) == 6
        iq, seqs, phases = pub.frames[-1]
        assert iq.shape == (4, L, 2) and iq.dtype == np.int8
        assert seqs.shape == (4,) and phases.shape == (4,)
        assert phases[0] == 1.0 + 0j
        assert np.allclose(np.abs(phases[1:]), 1.0, atol=1e-5)

    def test_converges_and_status(self):
        srv, _, _, truth = _server()
        srv.run(max_blocks=10)
        assert "3 / 3 synchronized" in srv.status()
        np.testing.assert_allclose(srv.state.delay, truth.delays, atol=0.05)

    def test_console_commands_through_dispatcher(self):
        srv, _, ctl, _ = _server()
        ctl.queue.append("request rd")
        srv.run(max_blocks=2)
        assert srv.refnoise_enabled is False and srv.source.refnoise_enabled is False
        ctl.queue += ["request re", "fcenter 868000000", "phase", "list all", "log"]
        srv.run(max_blocks=2)
        assert srv.refnoise_enabled is True
        assert srv.fcenter == 868000000
        assert "SYN 2" in srv.list_channels(all=True)
        assert len(srv.phase_table().split("\t")) == 3
        ctl.queue.append("quit")
        assert srv.run(max_blocks=10) <= 1

    def test_resync_request_clears_sync(self):
        srv, _, _, _ = _server()
        srv.run(max_blocks=8)
        assert srv.state.synced.all()
        srv.request_sync()
        srv.run(max_blocks=1)
        np.testing.assert_allclose(srv.state.delay, srv.state.lag, atol=0.5)

    def test_fs_change_rebuilds_and_resyncs(self):
        srv, _, _, _ = _server(scan_depth=4)
        srv.run(max_blocks=8)
        builds = srv.n_runner_builds
        assert srv.dispatcher.dispatch("fs 1024000") == "fs set to 1024000"
        assert srv.cfg.fs == 1024000.0 and srv.n_runner_builds == builds + 1
        assert srv._resync_requested
        srv.run(max_blocks=4)
        assert "3 / 3 synchronized" in srv.status()

    def test_checkpoint_roundtrip(self, tmp_path):
        path = str(tmp_path / "calib.npz")
        srv, _, _, truth = _server(state_path=path)
        srv.run(max_blocks=8)
        delay0 = srv.state.delay.copy()
        srv2, _, _, _ = _server(state_path=path)
        np.testing.assert_array_equal(srv2.state.delay, delay0)
        assert srv2.state.synced.all()
        srv2.run(max_blocks=2)
        np.testing.assert_allclose(srv2.state.delay, truth.delays, atol=0.05)

    def test_local_console_stdin(self, capsys):
        import io

        srv, _, _, _ = _server()
        srv.start_local_console(stream=io.StringIO("status\nquit\n"))
        deadline = time.monotonic() + 5.0
        while srv._local_lines.qsize() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.run(max_blocks=50) <= 2
        out = capsys.readouterr().out
        assert "synchronized" in out and "bye" in out


class GapInjectSource:
    """Wraps a source and skips one capture buffer of a channel at a block:
    the seqnum jumps."""

    def __init__(self, inner, gap_at: int, channel: int):
        self._inner, self._gap_at, self._ch = inner, gap_at, channel
        self._blocks = 0
        self._offset = None
        self.refnoise_enabled = True

    def next_block(self):
        sig, ref, seqs = self._inner.next_block()
        if self._offset is None:
            self._offset = np.zeros_like(seqs)
        if self._blocks == self._gap_at:
            self._offset[self._ch] += 1
        self._blocks += 1
        return sig, ref, seqs + self._offset


def _gap_server(gap_at, channel, scan_depth):
    truth = make_truth(3, seed=3, max_delay=20.0, snr_db=30.0)
    src = GapInjectSource(SyntheticStreamSource(truth, block_len=L, slab_blocks=8, seed=3,
                                                device="cpu"), gap_at=gap_at, channel=channel)
    return _server(source=src, scan_depth=scan_depth)[0]


class TestGapDetection:
    def test_gap_desync_relock_cycle(self):
        srv = _gap_server(8, 1, 1)
        srv.run(max_blocks=8)
        assert srv.state.synced.all() and srv.state.gaps.sum() == 0
        srv.run(max_blocks=1)   # the gapped block
        st = srv.state
        assert not st.synced[1] and st.synced[0]
        assert st.gaps[1] == 1 and st.gaps[0] == 0
        srv.run(max_blocks=4)   # re-lock
        assert srv.state.synced.all() and srv.state.gaps[1] == 1

    def test_scan_mode_detects_gaps_too(self):
        srv = _gap_server(9, 2, 4)
        srv.run(max_blocks=16)
        assert srv.state.gaps[2] == 1 and srv.state.synced.all()

    def test_drops_surface_in_status_log_and_frames(self):
        srv, pub, _, _ = _server(drop_rate=0.3, seed=5)
        srv.run(max_blocks=12)
        assert srv.state.gaps.sum() > 0
        st = srv.status()
        assert "seqnum gaps:" in st and "seqnum gaps: 0" not in st
        assert "blocks/s" in st and "phase drift" in st
        assert "seqnum gap on channel" in srv.drain_log() and srv.drain_log() == ""
        seqs = np.stack([f[1][1:] for f in pub.frames])
        assert detect_seqnum_gaps(seqs).sum() > 0

    def test_pipeline_survives_drops(self):
        srv, _, _, truth = _server(drop_rate=0.15, seed=7)
        srv.run(max_blocks=16)
        np.testing.assert_allclose(srv.state.delay, truth.delays, atol=0.6)


class TestHotPlug:
    def test_add_and_del_rebuild_unpadded(self):
        srv, pub, ctl, truth = _server()
        srv.run(max_blocks=8)
        delay_before = srv.state.delay.copy()
        ctl.queue.append("add NEWCH")
        srv.run(max_blocks=1)
        assert srv.cfg.n_channels == 4 and srv.n_runner_builds == 2
        srv.run(max_blocks=8)
        assert pub.frames[-1][0].shape[0] == 5
        np.testing.assert_allclose(srv.state.delay[:3], delay_before, atol=0.05)
        assert srv.state.synced.all()
        assert "no such channel" in srv.del_channel("NOPE")
        ctl.queue.append("del SYN 1")
        srv.run(max_blocks=2)
        assert srv.cfg.n_channels == 3 and pub.frames[-1][0].shape[0] == 4
        np.testing.assert_allclose(srv.state.delay[:2], truth.delays[[0, 2]], atol=0.05)

    @pytest.mark.parametrize("scan_depth", [1, 4])
    def test_padded_add_del_keep_the_runners(self, scan_depth):
        """max_channels padding: add/del move rows only (the runner count
        stays), calibration survives, and pad rows never show a gap."""
        srv, pub, ctl, truth = _server(max_channels=6, scan_depth=scan_depth)
        assert srv.cfg.n_channels == 6 and srv.n_active == 3
        srv.run(max_blocks=8)
        builds = srv.n_runner_builds
        delay_before = srv.state.delay[:3].copy()
        assert srv.state.gaps.sum() == 0 and "seqnum gaps: 0 total" in srv.status()
        ctl.queue.append("add NEWCH")
        srv.run(max_blocks=12)
        assert srv.n_runner_builds == builds and srv.n_active == 4
        assert pub.frames[-1][0].shape[0] == 5
        np.testing.assert_allclose(srv.state.delay[:3], delay_before, atol=0.05)
        assert srv.state.synced[:4].all()
        ctl.queue.append("del SYN 1")
        srv.run(max_blocks=scan_depth)   # the del lands after this batch
        srv.run(max_blocks=4)
        assert srv.n_runner_builds == builds and srv.n_active == 3
        assert pub.frames[-1][0].shape[0] == 4
        np.testing.assert_allclose(srv.state.delay[:2], truth.delays[[0, 2]], atol=0.1)
        assert srv.state.gaps[:3].sum() == 0 and "seqnum gaps: 0 total" in srv.status()

    def test_add_beyond_limit_refused(self):
        srv, _, _, _ = _server(max_channels=3)
        assert "limit" in srv.add_channel("X") and srv.n_active == 3


class TestPipelinedPublish:
    """The publisher worker: the order of frames, ref seqnums and channel
    seqnums survives the handoff; a publish error surfaces; a crash still
    saves the calibration; a second run continues the ref seqnums."""

    @pytest.mark.parametrize("scan_depth", [1, 8])
    def test_ordering(self, scan_depth):
        srv, pub, _, _ = _server(seed=5, scan_depth=scan_depth)
        assert srv.run(max_blocks=24) == 24
        assert [int(seq[0]) for _, seq, _ in pub.frames] == list(range(1, 25))
        for ch in range(1, 4):
            assert [int(seq[ch]) for _, seq, _ in pub.frames] == list(range(1, 25))
        for iq, _, ph in pub.frames:
            assert iq.shape == (4, L, 2) and ph[0] == 1.0 + 0j

    def test_publish_error_surfaces_in_run(self):
        class BoomPub(FakePublisher):
            def publish(self, *a, **k):
                if len(self.frames) >= 3:
                    raise RuntimeError("zmq send failed")
                return super().publish(*a, **k)

        srv, _, _, _ = _server(n=2, seed=6, scan_depth=2)
        srv.publisher = BoomPub()
        with pytest.raises(RuntimeError, match="zmq send failed"):
            srv.run(max_blocks=16)

    def test_crash_still_persists_calibration(self, tmp_path):
        class BoomPub(FakePublisher):
            def publish(self, *a, **k):
                if len(self.frames) >= 2:
                    raise RuntimeError("boom")
                return super().publish(*a, **k)

        path = str(tmp_path / "cal.npz")
        srv, _, _, _ = _server(n=2, seed=8, scan_depth=2, state_path=path)
        srv.publisher = BoomPub()
        with pytest.raises(RuntimeError, match="boom"):
            srv.run(max_blocks=12)
        assert os.path.exists(path) and np.load(path)["delay"].shape == (2,)

    def test_resume_after_run_keeps_ref_seq_contiguous(self):
        srv, pub, _, _ = _server(n=2, seed=7, scan_depth=4)
        assert srv.run(max_blocks=8) == 8 and srv.run(max_blocks=8) == 8
        assert [int(seq[0]) for _, seq, _ in pub.frames] == list(range(1, 17))


def test_console_fuzz_mid_stream():
    """Arbitrary bytes on the control socket never crash the loop or corrupt
    the stream, and no invalid fs lands."""
    import itertools
    import random

    rng = random.Random(42)
    srv, pub, _, _ = _server(n=2, seed=11, scan_depth=4)
    garbage = [
        "", " ", "\x00\xff\xfe", "fs", "fs banana", "fs -1e99", "fcenter 0",
        "fcenter 999999999999", "fcenter nan", "add", "del", "del NO_SUCH", "request",
        "request wat", "list all", "status", "phase", "log", "help", "fs 1024000",
        "request rd", "request re", "request sync", "request lag", "A" * 4096,
        "add \x01\x02", "nop nop nop",
    ]
    feed = itertools.cycle(garbage)

    class FuzzCtl:
        def poll(self, cb):
            for _ in range(rng.randint(0, 3)):
                cb(next(feed))

    srv.control = FuzzCtl()
    assert srv.run(max_blocks=40) == 40
    assert [int(seq[0]) for _, seq, _ in pub.frames] == list(range(1, 41))
    assert all(iq.shape[1:] == (L, 2) for iq, _, _ in pub.frames)
    assert srv.fs in (2.048e6, 1024000.0)


# ---- sockets, app, defaults ------------------------------------------------

def test_zmq_roundtrip_read_by_the_jax_client():
    """The port's server publishes through its pyzmq FramePublisher on ports
    the OS picks; the JAX package's client reads the frames (header, gseq
    contiguity, N + 1 channels) and gets a console reply."""
    zmq = pytest.importorskip("zmq")
    from coherent_rtlsdr_tpu.io.client import CoherentClient

    cap = _capture(L, 8)
    srv = CoherentServer(PipelineConfig(n_channels=3, block_len=L), FileSource(cap, loop=True),
                         data_addr="tcp://127.0.0.1:*", debug_addr="tcp://127.0.0.1:*",
                         ctrl_addr="tcp://127.0.0.1:*", device="cpu")
    endpoint = lambda sock: sock.getsockopt(zmq.LAST_ENDPOINT).decode()
    client = CoherentClient(data_addr=endpoint(srv.publisher.data),
                            ctrl_addr=endpoint(srv.control.sock),
                            debug_addr=endpoint(srv.publisher.debug), timeout_ms=2000)
    time.sleep(0.3)   # SUB joins before the first publish
    thread = threading.Thread(target=srv.run, daemon=True)
    thread.start()
    try:
        frames = [client.read() for _ in range(6)]
        reply = client.status()
        phases = client.read_phases()
    finally:
        srv.request_exit()
        thread.join(timeout=30)
        client.close()
        srv.publisher.close()
        srv.control.close()
    assert not thread.is_alive()
    assert all(f is not None for f in frames)
    gseq = [f.globalseqn for f in frames]
    assert gseq == list(range(gseq[0], gseq[0] + 6))
    for f in frames:
        assert f.x.shape == (4, L) and f.seqnums.shape == (4,)
    refseq = [int(f.seqnums[0]) for f in frames]
    assert refseq == list(range(refseq[0], refseq[0] + 6))
    assert "synchronized" in reply
    assert phases is not None and phases.shape == (4,) and phases[0] == 1.0


def test_app_runs_on_the_cpu(tmp_path, capsys):
    """``python3 -m coherent_rtlsdr_tpu_torch.apps.coherent_server --cpu``
    end to end on a recorded capture and on the synthetic stream, through
    its own sockets (ports the OS picks), with a checkpoint and a trace."""
    from coherent_rtlsdr_tpu_torch.io.streamio import save_capture

    path = str(tmp_path / "cap.npz")
    save_capture(path, _capture(L, 6))
    ports = ["-A", "tcp://127.0.0.1:*", "--ctrl-address", "tcp://127.0.0.1:*",
             "--debug-address", "tcp://127.0.0.1:*"]
    assert app.main(["--cpu", "--source", "file", "--capture", path, "-n", "3", "-b", str(L),
                     "--state", str(tmp_path / "cal.npz"), *ports]) == 0
    assert "published 6 frames" in capsys.readouterr().out
    assert np.load(str(tmp_path / "cal.npz"))["synced"].shape == (3,)
    assert app.main(["--cpu", "-n", "2", "-b", str(L), "--blocks", "5", "--scan-depth", "2",
                     "--max-channels", "3", "--trace", str(tmp_path / "trace"), *ports]) == 0
    assert "published 5 frames" in capsys.readouterr().out
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


@pytest.mark.parametrize("argv", [pytest.param(["--mesh", "3"], id="argv2"),
                                  pytest.param(["--mesh", "2", "--max-channels", "5"],
                                               id="max_channels")])
def test_app_refuses_what_is_not_ported(argv, capsys):
    """``--mesh S`` must divide the channel count (-n 4 by default), or
    ``--max-channels``: the app stops before any rank starts."""
    with pytest.raises(SystemExit):
        app.main(["--cpu", *argv])
    assert "must divide the channel width" in capsys.readouterr().err


class _MeshShape:
    """A stand-in for a DeviceMesh of the given (time, channel) shape: the
    server's mesh checks come before any collective."""

    def __init__(self, *shape):
        self.shape = shape

    def size(self, dim):
        return self.shape[dim]


def test_defaults_are_the_card_and_unported_options_raise():
    """The server defaults to device="cuda" and raises without a card; a
    mesh with a time axis larger than 1, or whose channel shards do not
    divide the channels, raises; a hardware drift relief is ticked from
    the loop with the applied delays and restored when the loop ends."""
    assert inspect.signature(CoherentServer).parameters["device"].default == "cuda"
    cfg = PipelineConfig(n_channels=2, block_len=L)
    kw = dict(publisher=FakePublisher(), control=FakeControl())
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            CoherentServer(cfg, None, **kw)
    with pytest.raises(ValueError, match="shards channels only"):
        CoherentServer(cfg, None, mesh=_MeshShape(2, 1), device="cpu", **kw)
    with pytest.raises(ValueError, match="not divisible by 3 channel shards"):
        CoherentServer(cfg, None, mesh=_MeshShape(1, 3), device="cpu", **kw)

    class Relief:
        def __init__(self):
            self.ticks, self.stops = [], 0

        def tick(self, delays):
            self.ticks.append(np.array(delays))

        def stop(self):
            self.stops += 1

    srv = CoherentServer(cfg, FileSource(_capture(L, 4, n=2)), device="cpu", **kw)
    assert srv.hw_relief is None
    relief = srv.hw_relief = Relief()
    assert srv.run() == 4
    assert relief.stops == 1 and 1 <= len(relief.ticks) <= 4
    assert all(t.shape == (2,) and t.dtype == np.float32 for t in relief.ticks)
