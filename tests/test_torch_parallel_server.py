"""The port's streaming server on a channel mesh against the JAX package's,
on the same bytes: ``parallel/sharded.py:make_sharded_server_runners``
against ``make_sharded_server_jits``, ``CoherentServer(mesh=...)`` against
the JAX mesh server (tests/test_server.py ``TestShardedServer``) and the
port's unsharded server, and ``apps/coherent_server.py --mesh 2``.

The port's ranks are gloo child processes on the CPU
(``tests/_torch_server_child.py``, at a low priority with one thread each,
joined through a FileStore under ``tmp_path``): rank 0 runs the server, the
others ``serve_follower``. This process runs the JAX mesh server on the
8-virtual-device CPU mesh (``tests/conftest.py``) and the port's unsharded
server. Bars, JAX ``TestShardedServer``'s: the same seqnums, wire bytes
within 1 LSB, phases within 1e-4, the same "N / N synchronized" line; the
runners' telemetry (papr relative) and state delay and phase within 1e-4
and ``wire_ref`` equal. On every rank: one runner build (two after a console ``fs``), and
hist row 0 (the reference history every rank keeps) equal to rank 0's.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu import parallel as jpar
from coherent_rtlsdr_tpu import pipeline as jpipe
from coherent_rtlsdr_tpu.io.server import CoherentServer as JaxServer
from coherent_rtlsdr_tpu.io.streamio import Capture as JaxCapture
from coherent_rtlsdr_tpu.parallel.sharded import make_sharded_server_jits
from coherent_rtlsdr_tpu.signal.sources import FileSource as JaxFileSource
from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
from coherent_rtlsdr_tpu_torch.io.streamio import Capture, save_capture
from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig
from coherent_rtlsdr_tpu_torch.pipeline.state import TELEMETRY_COLS
from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_capture
from coherent_rtlsdr_tpu_torch.signal.sources import FileSource, SyntheticStreamSource

REPO = Path(__file__).resolve().parents[1]
CHILD = REPO / "tests" / "_torch_server_child.py"
RANK_TIMEOUT_S = 120
NICE = ["nice", "-n", "10"]
L, LF = 1024, 2048   # xla; fused (2L = 64^2)
FUSED = dict(fft_impl="fused", lag_method="phase_zoom")
WIRE_LSB = 1
ATOL = 1e-4


class FakePublisher:
    def __init__(self):
        self.frames = []

    def publish(self, iq_i8, seqnums, phases=None):
        self.frames.append((np.array(iq_i8), np.array(seqnums), np.array(phases)))
        return iq_i8.size


class FakeControl:
    def poll(self, handler, timeout_ms=0):
        return 0


def _capture(n, T, seed, block_len):
    """(truth, sig [T, n, L, 2], ref [T, L, 2], seqnums [T, n] from 1)."""
    truth = make_truth(n, seed=seed, max_delay=20.0, snr_db=30.0)
    cap = synth_capture(torch.Generator().manual_seed(seed), truth, T, block_len)
    seqs = np.tile(np.arange(1, T + 1, dtype=np.uint32)[:, None], (1, n))
    return truth, cap.sig_u8.numpy(), cap.ref_u8.numpy(), seqs


def _cfg(n, block_len, impl="xla"):
    return dict(n_channels=n, block_len=block_len,
                **(FUSED if impl == "fused" else dict(fft_impl=impl)))


def _run_ranks(tmp_path, spec, world, sig, ref, seqs, fail_ok=()):
    """Run ``spec`` in ``world`` gloo ranks. Returns each rank's (npz, json)
    in rank order, and each rank's exit code; a rank outside ``fail_ok``
    must exit 0."""
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    np.savez(tmp_path / "in.npz", sig=sig, ref=ref, seqnums=seqs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(CHILD), str(tmp_path), str(r), str(world)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert r in fail_ok or p.returncode == 0, out
    ranks = []
    for r in range(world):
        npz, js = tmp_path / f"out_{r}.npz", tmp_path / f"out_{r}.json"
        ranks.append((dict(np.load(npz)) if npz.exists() else None,
                      json.loads(js.read_text()) if js.exists() else None))
    return ranks, [p.returncode for p in procs]


def _wire_within_1lsb(a, b):
    d = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
    assert d.max() <= WIRE_LSB, d.max()


def _assert_same_frames(want, got):
    """JAX TestShardedServer's bars on two frame lists (iq, seqs, phases)."""
    assert len(want) == len(got) > 0
    for (iq_w, seq_w, ph_w), (iq_g, seq_g, ph_g) in zip(want, got):
        assert iq_g.shape == iq_w.shape and iq_g.dtype == iq_w.dtype == np.int8
        np.testing.assert_array_equal(seq_g, seq_w)
        _wire_within_1lsb(iq_g, iq_w)
        np.testing.assert_allclose(ph_g, ph_w, rtol=0, atol=ATOL)


def _frames(npz):
    return list(zip(npz["iq"], npz["seqs"], npz["phases"]))


def _assert_every_rank(ranks, builds, blocks):
    """Each rank's runner builds and blocks served; hist row 0 equal."""
    for out, info in ranks:
        assert info["n_runner_builds"] == builds
        assert info["blocks_served"] == blocks
        np.testing.assert_array_equal(out["hist0"], ranks[0][0]["hist0"])


def _port_server(cfg, source, **kw):
    pub = FakePublisher()
    return CoherentServer(PipelineConfig(**cfg), source, publisher=pub, control=FakeControl(),
                          device="cpu", **kw), pub


def _jax_mesh_server(cfg, sig, ref, seqs, S, **kw):
    cap = JaxCapture(sig_u8=sig, ref_u8=ref, seqnums=seqs, fs=2.048e6, fcenter=868e6)
    pub = FakePublisher()
    srv = JaxServer(jpipe.PipelineConfig(**cfg), JaxFileSource(cap), publisher=pub,
                    control=FakeControl(), mesh=jpar.make_mesh(1, S), **kw)
    return srv, pub


def _file_source(sig, ref, seqs):
    return FileSource(Capture(sig_u8=sig, ref_u8=ref, seqnums=seqs, fs=2.048e6, fcenter=868e6))


# -- (a) the runners --------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 4], ids=["step", "scan4"])
@pytest.mark.parametrize("S", [2, 4], ids=["mesh1x2", "mesh1x4"])
@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_runners_match_jax(tmp_path, impl, S, K):
    """make_sharded_server_runners (rank 0's step, or scan at K = 4, over
    8 blocks from the initial state) against the JAX make_sharded_server_jits
    on the same bytes and mesh shape: wire within 1 LSB, wire_ref equal,
    telemetry and the final state's delay and phase within 1e-4 (papr, a
    ratio in the thousands, within 1e-4 of its value), the seqnum
    bookkeeping equal."""
    N, T = 4, 8
    block_len = LF if impl == "fused" else L
    _, sig, ref, seqs = _capture(N, T, seed=30 + S, block_len=block_len)
    if impl == "fused":
        sig, ref = sig.reshape(T, N, 2 * block_len), ref.reshape(T, 2 * block_len)
    cfg = _cfg(N, block_len, impl)
    ranks, _ = _run_ranks(tmp_path, dict(case="runners", cfg=cfg, K=K), S, sig, ref, seqs)

    step_fn, scan_fn = make_sharded_server_jits(jpipe.PipelineConfig(**cfg),
                                                jpar.make_mesh(1, S), scan_depth=K)
    state = jpipe.init_state(jpipe.PipelineConfig(**cfg))
    gate = jnp.array(True)
    wires, wire_refs, telems = [], [], []
    for t in range(0, T, K):
        b = slice(t, t + K)
        if K == 1:
            state, w, wr, tel = step_fn(state, jnp.asarray(sig[t]), jnp.asarray(ref[t]), gate,
                                        jnp.asarray(seqs[t]))
            w, wr, tel = w[None], wr[None], tel[None]
        else:
            state, (w, wr), tel = scan_fn(state, jnp.asarray(sig[b]), jnp.asarray(ref[b]), gate,
                                          jnp.asarray(seqs[b]))
        wires.append(np.asarray(w))
        wire_refs.append(np.asarray(wr))
        telems.append(np.asarray(tel))
    out = ranks[0][0]
    assert out["wire"].shape == np.concatenate(wires).shape
    _wire_within_1lsb(out["wire"], np.concatenate(wires))
    np.testing.assert_array_equal(out["wire_ref"], np.concatenate(wire_refs))
    telem, want = out["telem"], np.concatenate(telems)
    papr = TELEMETRY_COLS.index("papr")
    np.testing.assert_allclose(np.delete(telem, papr, -1), np.delete(want, papr, -1), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(telem[..., papr], want[..., papr], rtol=ATOL)
    np.testing.assert_allclose(out["state_delay"], np.asarray(state.delay), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out["state_phase"], np.asarray(state.phase), rtol=0, atol=ATOL)
    for leaf in ("synced", "last_seq", "gaps", "block_idx"):
        np.testing.assert_array_equal(out[f"state_{leaf}"], np.asarray(getattr(state, leaf)))
    _assert_every_rank(ranks, builds=1, blocks=T)


# -- (b) the server ---------------------------------------------------------------

@pytest.mark.parametrize("scan_depth", [1, 4])
def test_mesh_server_matches_jax_and_unsharded(tmp_path, scan_depth):
    """TestShardedServer.test_matches_unsharded_*: the (1, 2) mesh server on
    one FileSource capture against the JAX mesh server and the port's
    unsharded server: frames by the bars, "4 / 4 synchronized", the same
    final state."""
    N, T = 4, 12
    _, sig, ref, seqs = _capture(N, T, seed=21, block_len=L)
    cfg = _cfg(N, L)
    ranks, _ = _run_ranks(tmp_path, dict(case="server", cfg=cfg, scan_depth=scan_depth,
                                         runs=[[[], T]]), 2, sig, ref, seqs)
    out, info = ranks[0]
    assert info["published"] == [T] and info["status"] == "4 / 4 synchronized"
    jsrv, jpub = _jax_mesh_server(cfg, sig, ref, seqs, 2, scan_depth=scan_depth)
    assert jsrv.run() == T
    _assert_same_frames(jpub.frames, _frames(out))
    assert jsrv.status().splitlines()[0] == info["status"]
    usrv, upub = _port_server(cfg, _file_source(sig, ref, seqs), scan_depth=scan_depth)
    assert usrv.run() == T
    _assert_same_frames(upub.frames, _frames(out))
    st = usrv.state
    np.testing.assert_allclose(out["state_delay"], st.delay, rtol=0, atol=ATOL)
    np.testing.assert_allclose(out["state_phase"], st.phase, rtol=0, atol=ATOL)
    for leaf in ("synced", "last_seq", "gaps", "block_idx", "ref_hist"):
        np.testing.assert_array_equal(out[f"state_{leaf}"], getattr(st, leaf))
    _assert_every_rank(ranks, builds=1, blocks=T)


def test_fused_mesh_server_depth2(tmp_path):
    """TestShardedServer.test_fused_backend_on_mesh: the fused path on a
    (1, 2) mesh at scan depth 2, 4 blocks: flat bytes through the runners,
    frames (3, L, 2) int8 matching the JAX mesh server's and the unsharded
    server's, delays within 0.5 samples of the truth."""
    N, T = 2, 4
    truth, sig, ref, seqs = _capture(N, T, seed=23, block_len=LF)
    cfg = _cfg(N, LF, "fused")
    ranks, _ = _run_ranks(tmp_path, dict(case="server", cfg=cfg, scan_depth=2, runs=[[[], T]]),
                          2, sig, ref, seqs)
    out, info = ranks[0]
    assert info["frame_shapes"] == [[N + 1, LF, 2]] and out["iq"].dtype == np.int8
    jsrv, jpub = _jax_mesh_server(cfg, sig, ref, seqs, 2, scan_depth=2)
    assert jsrv.run() == T
    _assert_same_frames(jpub.frames, _frames(out))
    usrv, upub = _port_server(cfg, _file_source(sig, ref, seqs), scan_depth=2)
    assert usrv.run() == T
    _assert_same_frames(upub.frames, _frames(out))
    assert np.abs(out["state_delay"] - truth.delays).max() < 0.5
    _assert_every_rank(ranks, builds=1, blocks=T)


def test_hot_plug_on_mesh_requires_padding(tmp_path):
    """TestShardedServer.test_hot_plug_on_mesh_requires_padding: add and
    del on a mesh without max_channels are refused, and no rank rebuilds."""
    N = 4
    _, sig, ref, seqs = _capture(N, 2, seed=21, block_len=L)
    ranks, _ = _run_ranks(tmp_path, dict(case="server", cfg=_cfg(N, L), synth=21,
                                         runs=[[[], 2], [["add SH_X", "del SYN 1"], 2]]),
                          2, sig, ref, seqs)
    info = ranks[0][1]
    assert info["replies"] == [["add SH_X", "add with a device mesh requires --max-channels"],
                               ["del SYN 1", "del with a device mesh requires --max-channels"]]
    assert info["n_active"] == N and info["published"] == [2, 2]
    _assert_every_rank(ranks, builds=1, blocks=4)


def test_padded_hot_plug_on_mesh(tmp_path):
    """TestShardedServer.test_padded_hot_plug_on_mesh: 2 active channels
    padded to 4 on a (1, 2) mesh, so rank 1 holds pad rows only until the
    add; after "add SH_Y" the frames are (4, L, 2), "3 / 3", and no rank
    rebuilt its runners. Rank 1's pad rows step with contiguous synthetic
    seqnums (no gap), and the state and the frames after the add match the
    port's unsharded padded server on the same synthetic stream (but for
    the added channel)."""
    N = 2
    _, sig, ref, seqs = _capture(N, 2, seed=22, block_len=L)
    runs = [[[], 4], [["add SH_Y"], 4]]
    ranks, _ = _run_ranks(tmp_path, dict(case="server", cfg=_cfg(N, L), synth=22,
                                         max_channels=4, runs=runs), 2, sig, ref, seqs)
    out, info = ranks[0]
    assert info["replies"][0][1].startswith("added 'SH_Y'")
    assert info["published"] == [4, 4] and info["last_frame_shape"] == [4, L, 2]
    assert info["status"].startswith("3 / 3") and out["state_synced"][:3].all()
    # rank 1 held pad rows only through the first run
    assert info["seqs_after"][0] == dict(last_seq=[4, 4, 4, 4], gaps=[0, 0, 0, 0])
    _assert_every_rank(ranks, builds=1, blocks=8)

    truth = make_truth(N, seed=22, max_delay=20.0, snr_db=30.0)
    usrv, upub = _port_server(_cfg(N, L), SyntheticStreamSource(
        truth, block_len=L, slab_blocks=8, seed=22, device="cpu"), max_channels=4)
    assert usrv.run(max_blocks=4) == 4
    usrv.dispatcher.dispatch("add SH_Y")
    assert usrv.run(max_blocks=4) == 4
    # The added channel's truth comes from the serial's string hash, which
    # differs between processes: the rows that were there before it are
    # compared (frame rows: the reference and the two first channels).
    st, rows = usrv.state, [0, 1, 3]
    np.testing.assert_allclose(out["state_delay"][rows], st.delay[rows], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(out["state_last_seq"][rows], st.last_seq[rows])
    np.testing.assert_array_equal(out["state_gaps"], st.gaps)
    _assert_same_frames([(iq[:3], seq[:3], ph[:3]) for iq, seq, ph in upub.frames[4:]],
                        [(iq[:3], seq[:3], ph[:3]) for iq, seq, ph in _frames(out)])


@pytest.mark.parametrize("direction", ["mesh_to_unsharded", "unsharded_to_mesh"])
def test_checkpoint_across_mesh_and_unsharded(tmp_path, direction):
    """A calibration checkpoint written by the mesh server restores into the
    unsharded server, and the other way round: the reader resumes synced,
    its ref seqnums continuing, with the frames the other kind of reader
    publishes from the same checkpoint."""
    N, T = 4, 16
    _, sig, ref, seqs = _capture(N, T, seed=9, block_len=L)
    first = (sig[:8], ref[:8], seqs[:8])
    rest = (sig[8:], ref[8:], seqs[:8])   # a restarted capture counts from 1 again
    cfg = _cfg(N, L)
    path = tmp_path / "cal.npz"
    if direction == "mesh_to_unsharded":
        _run_ranks(tmp_path, dict(case="server", cfg=cfg, state="cal.npz", runs=[[[], 8]]), 2,
                   *first)
        writer, _ = _port_server(cfg, _file_source(*first), state_path=str(tmp_path / "u.npz"))
        writer.run()
        saved, want = np.load(path), np.load(tmp_path / "u.npz")
        np.testing.assert_allclose(saved["delay"], want["delay"], rtol=0, atol=ATOL)
        np.testing.assert_allclose(saved["phase_iq"], want["phase_iq"], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(saved["synced"], want["synced"])
        assert int(saved["block_idx"]) == 8
        reader, pub = _port_server(cfg, _file_source(*rest), state_path=str(path))
        st = reader.state
        np.testing.assert_array_equal(st.delay, saved["delay"])
        assert st.synced.all() and int(st.block_idx) == 8
        assert reader.run(max_blocks=1) == 1
        assert reader.state.synced.all() and int(pub.frames[0][1][0]) == 9
    else:
        writer, _ = _port_server(cfg, _file_source(*first), state_path=str(path))
        writer.run()
        shutil.copy(path, tmp_path / "u.npz")
        reader, pub = _port_server(cfg, _file_source(*rest), state_path=str(tmp_path / "u.npz"))
        assert reader.state.synced.all()
        assert reader.run() == 8
        ranks, _ = _run_ranks(tmp_path, dict(case="server", cfg=cfg, state="cal.npz",
                                             runs=[[[], 8]]), 2, *rest)
        out, info = ranks[0]
        assert int(out["seqs"][0][0]) == 9 and info["status"] == "4 / 4 synchronized"
        _assert_same_frames(pub.frames, _frames(out))


def test_console_fs_rebuilds_on_every_rank(tmp_path):
    """Console ``fs`` on a mesh server: every rank rebuilds its runners for
    the new rate (two builds each), and the server keeps publishing."""
    N, T = 4, 8
    _, sig, ref, seqs = _capture(N, T, seed=24, block_len=L)
    ranks, _ = _run_ranks(tmp_path, dict(case="server", cfg=_cfg(N, L),
                                         runs=[[[], 4], [["fs 1024000"], 4]]), 2, sig, ref, seqs)
    info = ranks[0][1]
    assert info["replies"] == [["fs 1024000", "fs set to 1024000"]]
    assert info["fs"] == 1024000.0 and info["published"] == [4, 4]
    _assert_every_rank(ranks, builds=2, blocks=T)


def test_killed_follower_makes_rank0_raise(tmp_path):
    """A follower that dies (it exits without a word once rank 0 has
    served 4 blocks) makes rank 0's next run raise well within the rank
    timeout, instead of hanging in a collective."""
    N = 4
    _, sig, ref, seqs = _capture(N, 2, seed=25, block_len=L)
    ranks, rcs = _run_ranks(tmp_path, dict(case="kill", cfg=_cfg(N, L), synth=25), 2, sig, ref,
                            seqs, fail_ok=(1,))
    info = ranks[0][1]
    assert rcs == [0, 3]
    assert info["raised"] is not None and info["seconds"] < RANK_TIMEOUT_S / 4, info


# -- (c) the app --------------------------------------------------------------------

def _app_capture(tmp_path, N=4, T=8):
    _, sig, ref, seqs = _capture(N, T, seed=26, block_len=L)
    path = tmp_path / "capture.npz"
    save_capture(str(path), Capture(sig_u8=sig, ref_u8=ref, seqnums=seqs, fs=2.048e6,
                                    fcenter=868e6))
    return path


APP_ARGS = ["--cpu", "--source", "file", "-n", "4", "-b", str(L), "--blocks", "8",
            "-A", "tcp://127.0.0.1:*", "--ctrl-address", "tcp://127.0.0.1:*",
            "--debug-address", "tcp://127.0.0.1:*"]


def _assert_same_checkpoint(a, b):
    a, b = np.load(a), np.load(b)
    np.testing.assert_allclose(a["delay"], b["delay"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(a["phase_iq"], b["phase_iq"], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(a["synced"], b["synced"])
    assert a["synced"].all()


@pytest.mark.parametrize("launcher", ["alone", "torchrun"])
def test_app_mesh2_matches_unsharded_app(tmp_path, launcher):
    """``coherent_server --mesh 2 --cpu --source file`` run as one command
    (it starts its own two ranks) or under ``torchrun --standalone``: it
    publishes the capture's 8 frames, and its checkpoint matches the
    unsharded app's on the same capture."""
    cap = _app_capture(tmp_path)
    args = [*APP_ARGS, "--capture", str(cap), "--mesh", "2", "--state", str(tmp_path / "m.npz")]
    cmd = [sys.executable, "-m", "coherent_rtlsdr_tpu_torch.apps.coherent_server", *args]
    if launcher == "torchrun":
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "coherent_rtlsdr_tpu_torch.apps.coherent_server",
               *args]
    out = subprocess.run([*NICE, *cmd], cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "published 8 frames" in out.stdout and "2 channel shards" in out.stdout
    assert "rank 1: 8 blocks of 2 channels, 1 runner builds" in out.stdout
    one = subprocess.run([*NICE, sys.executable, "-m",
                          "coherent_rtlsdr_tpu_torch.apps.coherent_server", *APP_ARGS,
                          "--capture", str(cap), "--state", str(tmp_path / "u.npz")],
                         cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    assert one.returncode == 0, one.stdout + one.stderr
    _assert_same_checkpoint(tmp_path / "m.npz", tmp_path / "u.npz")
