"""The port's native host slice against the JAX package, on the same bytes:

  * the port's ``CoherentServer`` reading a ``RingSource`` fed by the
    native file producer, against the JAX ``CoherentServer`` reading a
    ``FileSource`` of the same capture (fused at L = 2048, W = 64^2, and
    xla; scan depth 1 and 4), held to ``test_matches_jax_server``'s bars;
  * ``HwDriftRelief`` of both packages on one delay sequence;
  * ``ZmqSource`` of both packages on the same frames;
  * the ``align_offline`` apps of both packages on one capture npz, held to
    tests/test_torch_pipeline.py's offline bars;
  * the port's ``capture_daemon`` feeding the port's server through
    ``--source ring --ingest zmq:`` (after tests/test_apps.py's daemon
    chain), read by the port's client.
"""

import importlib.util
import itertools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.io import hwcontrol as jax_hwcontrol
from coherent_rtlsdr_tpu.io.server import CoherentServer as JaxServer
from coherent_rtlsdr_tpu.io.streamio import Capture
from coherent_rtlsdr_tpu.pipeline import PipelineConfig as JaxConfig
from coherent_rtlsdr_tpu.signal.sources import FileSource as JaxFileSource
from coherent_rtlsdr_tpu.signal.sources import ZmqSource as JaxZmqSource
from coherent_rtlsdr_tpu_torch import native
from coherent_rtlsdr_tpu_torch.apps import align_offline as align_app
from coherent_rtlsdr_tpu_torch.io import hwcontrol
from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
from coherent_rtlsdr_tpu_torch.io.streamio import save_capture
from coherent_rtlsdr_tpu_torch.io.wire import pack_frame
from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig
from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_capture
from coherent_rtlsdr_tpu_torch.signal.sources import RingSource, ZmqSource

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIRE_LSB = 1
PHASE_ATOL = 1e-4
_names = itertools.count()


def ipc_addr(tag):
    return f"ipc://@crt-slice-{os.getpid()}-{next(_names)}-{tag}"


class FakePublisher:
    def __init__(self):
        self.frames = []

    def publish(self, iq_i8, seqnums, phases=None):
        self.frames.append((np.array(iq_i8), np.array(seqnums), np.array(phases)))
        return iq_i8.size


class FakeControl:
    def poll(self, handler, timeout_ms=0):
        return 0


def _capture(L, T, n=3, seed=4):
    truth = make_truth(n, seed=seed, max_delay=20.0, snr_db=30.0)
    cap = synth_capture(torch.Generator().manual_seed(seed), truth, T, L)
    seqs = np.tile(np.arange(1, T + 1, dtype=np.uint32)[:, None], (1, n))
    return Capture(sig_u8=cap.sig_u8.numpy(), ref_u8=cap.ref_u8.numpy(), seqnums=seqs,
                   fs=2.048e6, fcenter=868e6)


def write_ring_file(path, cap):
    """The capture as raw ring blocks: the reference, then each channel."""
    with open(path, "wb") as f:
        for t in range(cap.n_blocks):
            f.write(np.concatenate([cap.ref_u8[t][None], cap.sig_u8[t]]).tobytes())


@pytest.mark.parametrize("scan_depth", [1, 4])
@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_ring_server_matches_jax_file_server(tmp_path, impl, scan_depth):
    """file producer -> native ring -> RingSource -> the port's server,
    against the JAX server on a FileSource of the same bytes and seqnums:
    the same frames (wire within 1 LSB), seqnums and phases, and the same
    gaps, last seqnums, sync flags and status line; no ring drops."""
    n, T = 3, 12
    L = 2048 if impl == "fused" else 1024
    cap = _capture(L, T)
    path = tmp_path / "capture.raw"
    write_ring_file(path, cap)
    kw = dict(n_channels=n, block_len=L, fft_impl=impl,
              lag_method="phase_zoom" if impl == "fused" else "phase_slope")
    ring = native.NativeBlockRing(16, (n + 1) * 2 * L, n_seq=n + 1)
    producer = native.NativeProducer.file(ring, str(path))
    jpub, tpub = FakePublisher(), FakePublisher()
    try:
        tsrv = CoherentServer(PipelineConfig(**kw), RingSource(ring, n, L, timeout_ms=5000),
                              publisher=tpub, control=FakeControl(), scan_depth=scan_depth,
                              device="cpu")
        assert tsrv.run(max_blocks=T) == T
    finally:
        producer.stop()
    assert ring.dropped == 0
    jsrv = JaxServer(JaxConfig(**kw), JaxFileSource(cap), publisher=jpub, control=FakeControl(),
                     scan_depth=scan_depth)
    assert jsrv.run() == T
    assert len(jpub.frames) == len(tpub.frames) == T
    for (jiq, jseq, jph), (tiq, tseq, tph) in zip(jpub.frames, tpub.frames):
        np.testing.assert_array_equal(tseq, jseq)
        assert tiq.shape == jiq.shape and tiq.dtype == np.int8
        assert np.abs(tiq.astype(np.int16) - jiq.astype(np.int16)).max() <= WIRE_LSB
        np.testing.assert_allclose(tph, jph, rtol=0, atol=PHASE_ATOL)
    js, ts = jsrv.state, tsrv.state
    np.testing.assert_allclose(ts.delay, np.asarray(js.delay), atol=2e-3)
    for name in ("gaps", "last_seq", "synced"):
        np.testing.assert_array_equal(getattr(ts, name), np.asarray(getattr(js, name)))
    assert tsrv.status().splitlines()[0] == jsrv.status().splitlines()[0] == "3 / 3 synchronized"


def test_hw_drift_relief_matches_jax():
    """One delay sequence through both packages' relief against a
    recording capture: the same correction calls, pulses and failures."""

    class Cap:
        def __init__(self):
            self.calls = []

        def set_correction_f(self, ch, p):
            self.calls.append((ch, p))
            return -1 if (ch, p) == (3, 0.0) else 0   # one failing restore

    rng = np.random.default_rng(8)
    delays = rng.normal(0, 20, (40, 4)).astype(np.float32)
    caps, reliefs = (Cap(), Cap()), []
    for mod, cap in zip((hwcontrol, jax_hwcontrol), caps):
        r = mod.HwDriftRelief(cap, fs=2.048e6, threshold=8.0, max_dwell_s=0.3)
        for i, d in enumerate(delays):
            r.tick(d, now=0.05 * i)
        r.stop()
        reliefs.append(r)
    assert caps[0].calls == caps[1].calls and len(caps[0].calls) > 10
    assert (reliefs[0].pulses, reliefs[0].failures) == (reliefs[1].pulses, reliefs[1].failures)
    assert hwcontrol.MAX_CORR == jax_hwcontrol.MAX_CORR
    assert (hwcontrol.SCALE, hwcontrol.FRAC_T) == (jax_hwcontrol.SCALE, jax_hwcontrol.FRAC_T)


@pytest.mark.parametrize("header", [True, False])
def test_zmq_source_matches_jax(header):
    """Both packages' ZmqSource subscribed to one PUB: the same blocks and
    seqnums, a malformed frame skipped by both."""
    zmq = pytest.importorskip("zmq")
    n, L, T = 2, 64, 5
    rng = np.random.default_rng(5)
    frames = [rng.integers(-128, 128, (n + 1, L, 2)).astype(np.int8) for _ in range(T)]
    ctx = zmq.Context()
    pub = ctx.socket(zmq.PUB)
    pub.bind("tcp://127.0.0.1:*")
    addr = pub.getsockopt(zmq.LAST_ENDPOINT).decode()
    kw = dict(timeout_ms=3000, header=header)
    if not header:
        kw.update(n_channels=n + 1, block_len=L)
    srcs = [ZmqSource(addr, **kw), JaxZmqSource(addr, **kw)]
    try:
        time.sleep(0.4)   # both SUBs join
        pub.send(b"\x01\x02")   # malformed
        for t, iq in enumerate(frames):
            seqs = np.array([t + 1, 10 + 2 * t, 20 + t], np.uint32)
            pub.send(pack_frame(t, seqs, iq) if header else iq.tobytes())
        for t, iq in enumerate(frames):
            (tsig, tref, tseq), (jsig, jref, jseq) = [s.next_block() for s in srcs]
            u8 = (iq.astype(np.int16) + 128).astype(np.uint8)
            np.testing.assert_array_equal(tref, u8[0])
            np.testing.assert_array_equal(tsig, u8[1:])
            np.testing.assert_array_equal(tsig, jsig)
            np.testing.assert_array_equal(tref, jref)
            np.testing.assert_array_equal(tseq, jseq)
            assert tseq.dtype == np.uint32
        assert srcs[0].malformed == srcs[1].malformed == 1
    finally:
        for s in srcs:
            s.close()
        pub.close(0)
        ctx.term()


def _jax_align_app(monkeypatch, tmp_path, argv):
    """The JAX package's apps/align_offline.py main() in this process."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(sys, "argv", ["align_offline.py", *argv])
    spec = importlib.util.spec_from_file_location("jax_align_offline_app",
                                                  os.path.join(REPO, "apps", "align_offline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()


@pytest.mark.parametrize("impl, smoothing", [("fused", "global"), ("xla", "ema")])
def test_align_offline_app_matches_jax(tmp_path, monkeypatch, capsys, impl, smoothing):
    """Both align_offline apps on one capture npz: the same npz keys and
    shapes; delay within 2e-3 samples, phase within 1e-3, mag within 1e-3,
    wire within 2 LSB with under 1e-3 of the bytes more than 1 apart, and
    the reference bytes equal."""
    L = 2048 if impl == "fused" else 1024
    src = tmp_path / "capture.npz"
    save_capture(str(src), _capture(L, 8, n=4, seed=6))
    args = [str(src), "--fft-impl", impl, "--smoothing", smoothing, "--cpu"]
    assert align_app.main([*args, "-o", str(tmp_path / "port.npz")]) == 0
    _jax_align_app(monkeypatch, tmp_path, [*args, "-o", str(tmp_path / "jax.npz")])
    assert "aligned 7 blocks x 4 ch" in capsys.readouterr().out
    t, j = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(t.files) == sorted(j.files)
    for k in t.files:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    np.testing.assert_allclose(t["delay"], j["delay"], atol=2e-3)
    np.testing.assert_allclose(t["phase"], j["phase"], atol=1e-3)
    np.testing.assert_allclose(t["mag"], j["mag"], atol=1e-3)
    d = np.abs(t["aligned_i8"].astype(np.int32) - j["aligned_i8"])
    assert d.max() <= 2 and (d > 1).mean() < 1e-3
    np.testing.assert_array_equal(t["ref_i8"], j["ref_i8"])
    assert float(t["fs"]) == float(j["fs"]) == 2.048e6


def test_align_offline_app_refusals(tmp_path):
    """The JAX app's ``--mesh`` errors: smoothing other than global (before
    any rank starts), and a mesh that does not divide the channels (each
    rank's argument error, exit code 2)."""
    with pytest.raises(SystemExit):
        align_app.main(["--synth", "2", "--mesh", "2", "--smoothing", "ema", "--cpu",
                        "-o", str(tmp_path / "x.npz")])
    assert align_app.main(["--synth", "3", "--blocks", "4", "--block-len", "1024", "--mesh", "2",
                           "--cpu", "-o", str(tmp_path / "x.npz")]) == 2
    assert not (tmp_path / "x.npz").exists()
    with pytest.raises(SystemExit):
        align_app.main(["--cpu", "-o", str(tmp_path / "x.npz")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--cpu"):
            align_app.main(["--synth", "2", "-o", str(tmp_path / "x.npz")])


def test_align_offline_app_synth_recovers_delays(tmp_path, capsys):
    out = tmp_path / "synth.npz"
    assert align_app.main(["--synth", "3", "--blocks", "6", "--block-len", "2048",
                           "--fft-impl", "fused", "--cpu", "-o", str(out)]) == 0
    truth = make_truth(3, seed=0, max_delay=40.0, snr_db=30.0)
    z = np.load(out)
    assert z["aligned_i8"].shape == (5, 3, 2048, 2) and z["phase"].dtype == np.complex64
    np.testing.assert_allclose(z["delay"][-1], truth.delays, atol=0.1)


def _run(cmd, **kw):
    return subprocess.Popen([sys.executable, "-m", *cmd], stdout=subprocess.PIPE, text=True,
                            cwd=REPO, **kw)


def _stop(procs):
    outs = []
    for p in procs:
        p.terminate()
    for p in procs:
        try:
            outs.append(p.communicate(timeout=60)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    return outs


@pytest.mark.parametrize("wire", ["header", "raw"])
def test_capture_daemon_feeds_the_ring_server(tmp_path, wire):
    """capture_daemon (synthetic stream on the CPU, injected per-channel
    drops) -> ZMQ -> the port's server with --source ring --ingest zmq: ->
    frames read by the port's client. With header frames a drop on one
    channel gaps exactly that channel downstream; raw frames carry no
    seqnums, so every channel shows the receiver's frame counter."""
    pytest.importorskip("zmq")
    from coherent_rtlsdr_tpu_torch.io.client import CoherentClient

    ingest, data, ctrl, debug = (ipc_addr(t) for t in ("ingest", "data", "ctrl", "debug"))
    errs = [open(tmp_path / f"{name}.err", "w") for name in ("daemon", "server")]
    daemon = _run(["coherent_rtlsdr_tpu_torch.apps.capture_daemon", "--cpu", "-n", "2", "-b",
                   "256", "--rate", "200", "--wire", wire, "--drop-rate", "0.15", "--seed", "6",
                   "-A", ingest, "--blocks", "6000"], stderr=errs[0])
    server = _run(["coherent_rtlsdr_tpu_torch.apps.coherent_server", "--cpu", "--source", "ring",
                   "--ingest", f"zmq:{ingest}", "-n", "2", "-b", "256", "--blocks", "4000",
                   "--ring-slots", "64", "-A", data, "--ctrl-address", ctrl,
                   "--debug-address", debug], stderr=errs[1])
    client = CoherentClient(data_addr=data, ctrl_addr=ctrl, timeout_ms=1000, max_retries=1)
    frames, status = [], ""
    try:
        deadline = time.time() + 90
        while len(frames) < 60 and time.time() < deadline and server.poll() is None:
            f = client.read()
            if f is not None:
                frames.append(f)
        status = client.status()
    finally:
        client.close()
        outs = _stop([daemon, server])
        for f in errs:
            f.close()
    assert len(frames) >= 40, (outs, (tmp_path / "server.err").read_text()[-1500:])
    assert all(f.x.shape == (3, 256) for f in frames)
    seqs = np.stack([f.seqnums for f in frames]).astype(np.int64)   # ref, ch 0, ch 1
    gseq = np.array([f.globalseqn for f in frames])
    d = np.diff(seqs, axis=0)[np.diff(gseq) == 1]   # consecutive frames
    clean = d[d[:, 0] == 1]   # no frame lost at the ring
    assert len(clean) >= 20
    if wire == "header":
        one_channel = (clean[:, 1:] > 1) & ~np.all(clean[:, 1:] > 1, axis=1, keepdims=True)
        assert one_channel.any(), clean[:20]
        assert int(status.split("seqnum gaps:")[1].split()[0]) > 0, status
    else:
        assert (seqs[:, 1] == seqs[:, 2]).all() and (clean[:, 1:] >= 1).all()


@pytest.mark.parametrize("module", ["io/client.py", "io/hwcontrol.py"])
def test_copies_differ_from_jax_only_in_imports(module):
    """``io/client.py`` (with the stale-reply fault ROADMAP.md records as
    shared) and ``io/hwcontrol.py`` are the JAX package's files with the
    package name changed, line for line."""
    port = open(os.path.join(REPO, "coherent_rtlsdr_tpu_torch", module)).read()
    jax = open(os.path.join(REPO, "coherent_rtlsdr_tpu", module)).read()
    assert port.replace("coherent_rtlsdr_tpu_torch", "coherent_rtlsdr_tpu") == jax
