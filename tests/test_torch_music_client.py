"""The port's MUSIC client app (``python3 -m
coherent_rtlsdr_tpu_torch.apps.music_client``) on the CPU, fed over ZMQ by a
feeder that publishes the port's wire frames (``io/wire.pack_frame``) on a
port the OS picks.

On frames that carry a plane-wave source at a known (u, v), the printed
peak lies within one grid step of it, and the saved spectrum equals the JAX
package's spectrum of the ``.mat`` file's snapshots, computed here on the
CPU, at tests/test_torch_models.py's bars (MUSIC: the same argmax and 0.1 dB
where within 30 dB of the peak; Bartlett rtol 1e-4; MVDR rtol 1e-3; both
with an atol of rtol times the peak, for Bartlett's nulls). On
random frames (where the signal / noise split is arbitrary) only shapes and
files are checked. The child's stderr goes to a file, never an unread pipe.
"""

import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

zmq = pytest.importorskip("zmq")
scipy_io = pytest.importorskip("scipy.io")

from coherent_rtlsdr_tpu.models import beamform as jbf
from coherent_rtlsdr_tpu.models import coarray as jco
from coherent_rtlsdr_tpu.models import geometry as jgeo
from coherent_rtlsdr_tpu_torch.io.wire import pack_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP = [sys.executable, "-m", "coherent_rtlsdr_tpu_torch.apps.music_client"]
L, GRID = 128, 24
STEP = 2.0 / (GRID - 1)
UV0 = np.array([0.3, -0.2])
BARTLETT_RTOL, MVDR_RTOL = 1e-4, 1e-3
MUSIC_DB, MUSIC_WITHIN_DB = 0.1, 30.0
PEAK = re.compile(r"peak at \(u, v\) = \(([-+.\d]+), ([-+.\d]+)\)")


class _Feeder:
    """Publishes ``frames`` round-robin every ``period_s`` on an OS-picked
    loopback port until stopped (the server stand-in). With ``count``, an
    XPUB socket waits for the client's subscription and then publishes
    exactly ``count`` frames, all of which the subscriber receives (a PUB
    socket drops what it sends before the subscription arrives)."""

    def __init__(self, frames, period_s=0.02, count=None):
        self.ctx = zmq.Context()
        self.pub = self.ctx.socket(zmq.PUB if count is None else zmq.XPUB)
        self.pub.bind("tcp://127.0.0.1:*")
        self.address = self.pub.getsockopt_string(zmq.LAST_ENDPOINT)
        self.frames, self.period, self.count = frames, period_s, count
        self._stop = threading.Event()
        self.th = threading.Thread(target=self._run, daemon=True)
        self.th.start()

    def _run(self):
        if self.count is not None:
            while not self._stop.is_set() and not self.pub.poll(50):
                pass
            if self._stop.is_set():
                return
            self.pub.recv()   # the subscription: from here on nothing is dropped
        k = 0
        n = self.frames[0].shape[0]
        while not self._stop.is_set() and (self.count is None or k < self.count):
            seqs = np.full(n, k + 1, np.uint32)
            self.pub.send(pack_frame(k, seqs, self.frames[k % len(self.frames)]))
            k += 1
            time.sleep(self.period)

    def stop(self):
        self._stop.set()
        self.th.join(timeout=5)
        assert not self.th.is_alive()
        self.pub.close(0)
        self.ctx.term()


def _plane_wave_frames(n_frames, positions, uv0, seed):
    """Ref + one channel a sensor: the ref carries s(t), sensor n carries
    exp(2 pi i p_n . uv0) s(t) plus noise 20 dB down, as int8 IQ."""
    rng = np.random.default_rng(seed)
    a = np.exp(2j * np.pi * positions.astype(np.float64) @ np.asarray(uv0, np.float64))
    frames = []
    for _ in range(n_frames):
        s = (rng.standard_normal(L) + 1j * rng.standard_normal(L)) * (30 / np.sqrt(2))
        noise = (rng.standard_normal((len(a), L))
                 + 1j * rng.standard_normal((len(a), L))) * (3 / np.sqrt(2))
        x = np.concatenate([s[None], a[:, None] * s[None] + noise])
        frames.append(np.stack([x.real, x.imag], -1).round().clip(-128, 127).astype(np.int8))
    return frames


def _rand_frames(n_frames, n_ch, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(-128, 128, (n_ch, L, 2)).astype(np.int8) for _ in range(n_frames)]


def _peaks(text):
    return [(float(u), float(v)) for u, v in PEAK.findall(text)]


def _run_once(tmp_path, address, *extra):
    out, mat = str(tmp_path / "hm.npy"), str(tmp_path / "hm.mat")
    with open(tmp_path / "client.err", "w+") as err:
        r = subprocess.run(APP + ["--cpu", "-a", address, "--frames", "2", "--grid", str(GRID),
                                  "-o", out, "--mat", mat, "--timeout-ms", "20000", *extra],
                           stdout=subprocess.PIPE, stderr=err, text=True, timeout=120, cwd=REPO)
        err.seek(0)
        assert r.returncode == 0, err.read()[-3000:]
    return r.stdout, np.load(out), scipy_io.loadmat(mat)


def assert_music_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and got.argmax() == want.argmax()
    near = want >= want.max() * 10 ** (-MUSIC_WITHIN_DB / 10)
    err_db = np.abs(10 * np.log10(got[near]) - 10 * np.log10(want[near]))
    assert err_db.max() <= MUSIC_DB, err_db.max()


def _jax_spectrum(method, x, positions):
    """The JAX package's spectrum of the .mat file's snapshots x [T, N]."""
    R = jbf.sample_covariance(x.T)
    uv, _ = jgeo.uv_grid(GRID)
    A = jgeo.steering_vectors(positions, uv)
    P = {"music": lambda: jbf.music_spectrum(R, A, 1),
         "bartlett": lambda: jbf.bartlett_spectrum(R, A),
         "mvdr": lambda: jbf.mvdr_spectrum(R, A)}[method]()
    return np.asarray(P).reshape(GRID, GRID)


@pytest.mark.parametrize("method", ["music", "bartlett", "mvdr"])
def test_one_shot_plane_wave(tmp_path, method):
    pos = jgeo.ura_positions(3, 2, 0.5)
    feeder = _Feeder(_plane_wave_frames(4, pos, UV0, seed=1))
    try:
        stdout, P, m = _run_once(tmp_path, feeder.address, "--rows", "3", "--cols", "2",
                                 "--method", method)
    finally:
        feeder.stop()
    (u, v), = _peaks(stdout)
    assert abs(u - UV0[0]) <= STEP and abs(v - UV0[1]) <= STEP, (u, v)
    assert re.search(rf"{method} spectrum [\d.]+ ms on cpu", stdout), stdout
    x = m["x"]
    assert x.dtype == np.complex64 and x.shape == (2 * L, 6)
    np.testing.assert_array_equal(m["P"], P)
    want = _jax_spectrum(method, x, pos)
    if method == "music":
        assert_music_close(P, want)
    else:
        # Bartlett's a^H R a cancels to near zero at the array factor's
        # nulls, where its float32 rounding (in either package) scales with
        # the peak, not the value: the bar's atol is rtol times the peak.
        rtol = {"bartlett": BARTLETT_RTOL, "mvdr": MVDR_RTOL}[method]
        np.testing.assert_allclose(P, want, rtol=rtol, atol=rtol * want.max())


@pytest.mark.parametrize("positions_as", ["string", "npy"])
def test_one_shot_coarray(tmp_path, positions_as):
    """--coarray 7x1 on the minimum-redundancy array {0, 1, 4, 6}."""
    grid_pos = np.array([[0, 0], [1, 0], [4, 0], [6, 0]])
    positions = "0,0;1,0;4,0;6,0"
    if positions_as == "npy":
        positions = str(tmp_path / "pos.npy")
        np.save(positions, grid_pos)
    feeder = _Feeder(_plane_wave_frames(4, grid_pos * 0.5, UV0, seed=2))
    try:
        stdout, P, m = _run_once(tmp_path, feeder.address, "--coarray", "7x1",
                                 "--positions", positions)
    finally:
        feeder.stop()
    (u, _), = _peaks(stdout)
    assert abs(u - UV0[0]) <= STEP, u
    assert "coarray music spectrum" in stdout
    uv, _ = jgeo.uv_grid(GRID)
    R = jbf.sample_covariance(m["x"].T)
    want = np.array(jco.coarray_music_spectrum(R, grid_pos, (7, 1), uv, 1)).reshape(GRID, GRID)
    assert_music_close(P, want)


class _Follower:
    """The client in --follow mode, its stdout read by a thread."""

    def __init__(self, tmp_path, address, *extra, env=None):
        self.err = open(tmp_path / "client.err", "w+")
        self.proc = subprocess.Popen(APP + ["--cpu", "-a", address, "--follow", *extra],
                                     stdout=subprocess.PIPE, stderr=self.err, text=True,
                                     cwd=REPO, env=env)
        self.lines, self.last_line_at = [], time.time()
        self.th = threading.Thread(target=self._read, daemon=True)
        self.th.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            self.last_line_at = time.time()

    @property
    def text(self):
        return "".join(self.lines)

    def wait_for(self, cond, seconds):
        deadline = time.time() + seconds
        while time.time() < deadline and not cond() and self.proc.poll() is None:
            time.sleep(0.05)
        return cond()

    def stop(self):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self.th.join(timeout=10)
        self.err.seek(0)
        tail = self.err.read()[-3000:]
        self.err.close()
        return tail


@pytest.mark.parametrize("frames", ["plane_wave", "random"])
def test_follow_mat_and_plot(tmp_path, frames):
    """--follow re-renders until killed; --mat and --plot (Agg) re-written
    each iteration. The feeder publishes exactly ITERATIONS x 2 frames after
    the client subscribed, so iteration ITERATIONS - 1 is the client's last:
    once its line is out, the .npy is final, and a .mat written after it
    (a later mtime) is that iteration's. The client then rests in its
    receive with the last iteration's files complete."""
    iterations = 3
    pos = jgeo.ura_positions(3, 2, 0.5)
    data = (_plane_wave_frames(4, pos, UV0, seed=3) if frames == "plane_wave"
            else _rand_frames(4, 7, seed=3))
    out, mat, png = (str(tmp_path / n) for n in ("hm.npy", "hm.mat", "hm.png"))
    feeder = _Feeder(data, count=2 * iterations)
    client = _Follower(tmp_path, feeder.address, "--frames", "2", "--rows", "3", "--cols", "2",
                       "--grid", str(GRID), "-o", out, "--mat", mat, "--plot", png,
                       "--timeout-ms", "20000", env=dict(os.environ, MPLBACKEND="Agg"))
    try:
        last = f"[{iterations - 1}] music spectrum"
        ok = client.wait_for(lambda: last in client.text, 120)
        feeder.stop()
        settled = client.wait_for(
            lambda: (os.path.exists(mat)
                     and os.stat(mat).st_mtime_ns > os.stat(out).st_mtime_ns), 30)
        alive = client.proc.poll() is None
    finally:
        if feeder.th.is_alive():
            feeder.stop()
        err_tail = client.stop()
    assert ok and settled and alive, (client.text[-2000:], err_tail)
    P = np.load(out)
    m = scipy_io.loadmat(mat)
    assert P.shape == (GRID, GRID) and m["P"].shape == (GRID, GRID)
    assert m["x"].dtype == np.complex64 and m["x"].shape == (2 * L, 6)
    with open(png, "rb") as f:
        assert f.read(8)[:4] == b"\x89PNG"
    if frames == "plane_wave":
        np.testing.assert_array_equal(m["P"], P)   # one iteration's pair
        assert_music_close(P, _jax_spectrum("music", m["x"], pos))
        u, v = _peaks(client.text)[-1]
        assert abs(u - UV0[0]) <= STEP and abs(v - UV0[1]) <= STEP, (u, v)


def test_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with open(tmp_path / "client.err", "w+") as err:
        r = subprocess.run(APP + ["-a", "tcp://127.0.0.1:1", "--timeout-ms", "100"],
                           stdout=subprocess.PIPE, stderr=err, text=True, timeout=120, cwd=REPO)
        err.seek(0)
        tail = err.read()
    assert r.returncode != 0 and "found none; pass --cpu" in tail, tail[-2000:]


def test_coarray_requires_positions(tmp_path):
    with open(tmp_path / "client.err", "w+") as err:
        r = subprocess.run(APP + ["--cpu", "--coarray", "7x1", "-a", "tcp://127.0.0.1:1"],
                           stdout=subprocess.PIPE, stderr=err, text=True, timeout=120, cwd=REPO)
        err.seek(0)
        tail = err.read()
    assert r.returncode == 2 and "--coarray requires --positions" in tail, tail[-2000:]
