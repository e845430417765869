"""The port's native host runtime (``coherent_rtlsdr_tpu_torch/native.py``
over ``csrc/coherent_host.cc``), case by case after tests/test_native.py:
the ring, the conversion hot loops (also against the port's
``ops/convert``), ``RingSource``, the publisher's wire parity (against the
port's ``io/wire.pack_frame`` and the JAX package's jax-free ``io/wire``),
the file and ZMQ producers; then the library's own build at first use.

The library builds itself with g++ here, so these tests run (the JAX
package's copies skip without ``make -C native``). Sockets are Linux
abstract-namespace ``ipc://@...`` names or ports the OS picks, never fixed
TCP ports.
"""

import itertools
import os
import struct
import threading
import time

import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.io import wire as jax_wire
from coherent_rtlsdr_tpu_torch import native
from coherent_rtlsdr_tpu_torch.io.wire import pack_frame, unpack_frame
from coherent_rtlsdr_tpu_torch.ops.convert import c64_to_i8_iq, u8_to_c64, u8_to_i8
from coherent_rtlsdr_tpu_torch.signal.sources import RingSource

_names = itertools.count()


def ipc_addr(tag: str) -> str:
    """A fresh abstract-namespace IPC endpoint (no file, no port)."""
    return f"ipc://@crt-native-{os.getpid()}-{next(_names)}-{tag}"


def _pub_and_endpoint(zmq, ctx):
    pub = ctx.socket(zmq.PUB)
    pub.bind("tcp://127.0.0.1:*")
    return pub, pub.getsockopt(zmq.LAST_ENDPOINT).decode()


def _wait(cond, seconds=5.0):
    deadline = time.time() + seconds
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


class TestRing:
    def test_push_pop_fifo(self):
        ring = native.NativeBlockRing(8, 64)
        for i in range(5):
            assert ring.push(np.full(64, i, np.uint8), seqnum=100 + i) >= 0
        assert ring.fill == 5
        for i in range(5):
            out, seq, ts = ring.pop()
            assert seq == 100 + i and out[0] == i and ts > 0
        assert ring.pop() is None

    def test_overflow_drops(self):
        ring = native.NativeBlockRing(4, 16)
        blk = np.zeros(16, np.uint8)
        for i in range(4):
            assert ring.push(blk, i) >= 0
        assert ring.push(blk, 99) == -1   # full: dropped and counted
        assert ring.dropped == 1

    def test_blocking_pop(self):
        ring = native.NativeBlockRing(4, 16)
        result = {}
        t = threading.Thread(target=lambda: result.update(blk=ring.pop(timeout_ms=2000)))
        t.start()
        time.sleep(0.05)
        ring.push(np.arange(16, dtype=np.uint8), 7)
        t.join()
        out, seq, _ = result["blk"]
        assert seq == 7 and out[3] == 3

    def test_rejects_non_pow2(self):
        with pytest.raises(ValueError):
            native.NativeBlockRing(3, 16)

    def test_per_channel_tracks(self):
        """``n_seq`` tracks a slot: pop_n returns each; a short push repeats
        its last seqnum over the rest."""
        ring = native.NativeBlockRing(4, 8, n_seq=3)
        assert ring.n_seq == 3
        ring.push(np.zeros(8, np.uint8), [5, 6, 9])
        ring.push(np.ones(8, np.uint8), 4)
        _, seqs, _ = ring.pop_n()
        np.testing.assert_array_equal(seqs, [5, 6, 9])
        _, seqs, _ = ring.pop_n()
        np.testing.assert_array_equal(seqs, [4, 4, 4])

    def test_pops_never_share_a_buffer(self):
        """Each pop fills a fresh array, so the server's asynchronous upload
        of one block never races the next pop."""
        ring = native.NativeBlockRing(4, 16)
        ring.push(np.zeros(16, np.uint8), 1)
        ring.push(np.ones(16, np.uint8), 2)
        a, _, _ = ring.pop()
        b, _, _ = ring.pop()
        assert not np.shares_memory(a, b) and a[0] == 0 and b[0] == 1


class TestConvert:
    def test_requantize_matches_numpy(self):
        x = np.random.default_rng(0).normal(0, 0.5, 4096).astype(np.float32)
        expect = np.clip(np.rint(x * 127.0), -128, 127).astype(np.int8)
        np.testing.assert_array_equal(native.requantize_i8(x, 127.0), expect)

    def test_dequantize_matches_formula(self):
        x = np.arange(256, dtype=np.uint8)
        expect = (x.astype(np.float32) - 128.0) / 127.0
        np.testing.assert_allclose(native.dequantize_u8(x), expect, rtol=1e-6)

    def test_roundtrip(self):
        u8 = np.random.default_rng(1).integers(0, 256, 1024, dtype=np.uint8)
        back = native.requantize_i8(native.dequantize_u8(u8), 127.0)
        np.testing.assert_array_equal(back, (u8.astype(np.int16) - 128).astype(np.int8))

    def test_against_ops_convert(self):
        """The hot loops against the port's own conversions: dequantize is
        ``u8_to_c64``'s rails, requantize is ``c64_to_i8_iq`` (round half
        to even, saturate), and their round trip is ``u8_to_i8``."""
        rng = np.random.default_rng(2)
        u8 = rng.integers(0, 256, (64, 2), dtype=np.uint8)
        c = u8_to_c64(torch.from_numpy(u8))
        np.testing.assert_array_equal(native.dequantize_u8(u8),
                                      torch.stack([c.real, c.imag], -1).numpy())
        x = rng.normal(0, 90, (64, 2)).astype(np.float32)
        x[:4] = [[0.5, -0.5], [1.5, 2.5], [300, -300], [127.49, -128.6]]
        want = c64_to_i8_iq(torch.complex(torch.from_numpy(x[:, 0]), torch.from_numpy(x[:, 1])),
                            scale=1.0)
        np.testing.assert_array_equal(native.requantize_i8(x, 1.0), want.numpy())
        back = native.requantize_i8(native.dequantize_u8(u8), 127.0)
        np.testing.assert_array_equal(back, u8_to_i8(torch.from_numpy(u8)).numpy())


class TestRingSource:
    def test_ring_feeds_pipeline_source(self):
        n, L = 3, 64
        ring = native.NativeBlockRing(8, (n + 1) * L * 2)
        src = RingSource(ring, n_channels=n, block_len=L, timeout_ms=1000)
        rng = np.random.default_rng(0)
        frames = [rng.integers(0, 256, (n + 1, L, 2), dtype=np.uint8) for _ in range(3)]
        for i, f in enumerate(frames):
            ring.push(f.reshape(-1), seqnum=100 + i)
        for i, f in enumerate(frames):
            sig, ref, seqs = src.next_block()
            np.testing.assert_array_equal(ref, f[0])
            np.testing.assert_array_equal(sig, f[1:])
            assert seqs.dtype == np.uint32 and (seqs == 100 + i).all()
        t0 = time.time()
        assert src.next_block() is None   # drained: the pop times out
        assert time.time() - t0 >= 0.9

    def test_per_channel_ring_and_drain(self):
        """A per-channel ring (capacity 4 channels + ref, 2 active): the
        source reads the active rows' own seqnums; ``drain`` empties it."""
        n, cap, L = 2, 4, 32
        ring = native.NativeBlockRing(8, (cap + 1) * L * 2, n_seq=cap + 1)
        src = RingSource(ring, n_channels=n, block_len=L, timeout_ms=100)
        f = np.random.default_rng(3).integers(0, 256, (cap + 1, L, 2), dtype=np.uint8)
        for t in range(3):
            ring.push(f.reshape(-1), [10 + t, 20 + t, 30 + t, 0, 0])
        sig, ref, seqs = src.next_block()
        np.testing.assert_array_equal(ref, f[0])
        np.testing.assert_array_equal(sig, f[1:1 + n])
        np.testing.assert_array_equal(seqs, [20, 30])
        assert src.drain() == 2 and ring.fill == 0 and src.next_block() is None


class TestNativePublisher:
    def test_wire_parity_with_python(self):
        """The native packetizer's bytes equal the port's ``pack_frame``
        and the JAX package's, and its debug frame the phases."""
        zmq = pytest.importorskip("zmq")
        rng = np.random.default_rng(2)
        iq = rng.integers(-128, 128, (3, 32, 2)).astype(np.int8)
        seqnums = np.array([5, 6, 7], np.uint32)
        phases = np.exp(1j * np.array([0.1, 0.2, 0.3])).astype(np.complex64)
        data, debug = ipc_addr("data"), ipc_addr("debug")
        ctx = zmq.Context()
        sub, dbg = ctx.socket(zmq.SUB), ctx.socket(zmq.SUB)
        for s in (sub, dbg):
            s.setsockopt(zmq.SUBSCRIBE, b"")
            s.setsockopt(zmq.RCVTIMEO, 5000)
        pub = native.NativePublisher(data, debug)
        try:
            sub.connect(data)
            dbg.connect(debug)
            time.sleep(0.3)   # the SUBs join before the first publish
            n = pub.publish(iq, seqnums, phases)
            buf = sub.recv()
            assert len(buf) == n
            assert buf == pack_frame(0, seqnums, iq) == jax_wire.pack_frame(0, seqnums, iq)
            frame = unpack_frame(buf)
            np.testing.assert_array_equal(frame.iq, iq)
            np.testing.assert_array_equal(frame.seqnums, seqnums)
            np.testing.assert_array_equal(np.frombuffer(dbg.recv(), np.complex64), phases)
            pub.publish(iq, seqnums, phases)
            assert unpack_frame(sub.recv()).globalseqn == 1 == pub.globalseqn - 1
        finally:
            pub.close()
            sub.close(0)
            dbg.close(0)
            ctx.term()

    def test_raw_mode_and_bind_failure(self):
        zmq = pytest.importorskip("zmq")
        iq = np.arange(24, dtype=np.int8).reshape(2, 6, 2)
        data = ipc_addr("raw")
        ctx = zmq.Context()
        sub = ctx.socket(zmq.SUB)
        sub.setsockopt(zmq.SUBSCRIBE, b"")
        sub.setsockopt(zmq.RCVTIMEO, 5000)
        pub = native.NativePublisher(data, header=False)
        try:
            sub.connect(data)
            time.sleep(0.3)
            pub.publish(iq, np.array([1, 2], np.uint32))
            assert sub.recv() == iq.tobytes()
            with pytest.raises(RuntimeError, match="could not bind"):
                native.NativePublisher(data)   # taken
        finally:
            pub.close()
            sub.close(0)
            ctx.term()


class TestNativeProducer:
    """The C++ capture threads: the file replayer and the ZMQ receiver
    feeding the ring."""

    def _frames(self, n, L, count, seed=0):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, 256, (n + 1, L, 2), dtype=np.uint8) for _ in range(count)]

    def _write(self, path, frames):
        with open(path, "wb") as f:
            for fr in frames:
                f.write(fr.tobytes())

    def test_file_producer_feeds_ring_source(self, tmp_path):
        n, L, T = 3, 64, 5
        frames = self._frames(n, L, T)
        path = tmp_path / "capture.raw"
        self._write(path, frames)
        ring = native.NativeBlockRing(16, (n + 1) * L * 2)
        prod = native.NativeProducer.file(ring, str(path))
        src = RingSource(ring, n_channels=n, block_len=L, timeout_ms=2000)
        try:
            for i, fr in enumerate(frames):
                sig, ref, seqs = src.next_block()
                np.testing.assert_array_equal(ref, fr[0])
                np.testing.assert_array_equal(sig, fr[1:])
                assert seqs[0] == i + 1
            assert _wait(lambda: not prod.running, 2.0)   # EOF, no loop
            assert prod.pushed == T and not prod.error
        finally:
            prod.stop()
        assert prod.pushed == 0 and not prod.running   # freed

    def test_file_producer_paced_and_looping(self, tmp_path):
        n, L, T = 1, 32, 10
        path = tmp_path / "cap.raw"
        self._write(path, self._frames(n, L, T, seed=1))
        ring = native.NativeBlockRing(16, (n + 1) * L * 2)
        t0 = time.time()
        prod = native.NativeProducer.file(ring, str(path), rate_blocks_per_s=100.0)
        try:
            assert _wait(lambda: not prod.running)
            assert prod.pushed == T
            assert time.time() - t0 >= 0.9 * T / 100.0   # the pacing slept
        finally:
            prod.stop()
        ring = native.NativeBlockRing(64, (n + 1) * L * 2)
        prod = native.NativeProducer.file(ring, str(path), loop=True)
        try:
            assert _wait(lambda: ring.dropped > 0)   # the loop runs on into a full ring
            assert prod.running
            seqs = [ring.pop()[1] for _ in range(64)]
            assert seqs == list(range(1, 65))   # the frame counter runs on across the seam
        finally:
            prod.stop()

    def test_file_producer_missing_file(self, tmp_path):
        ring = native.NativeBlockRing(4, 64)
        prod = native.NativeProducer.file(ring, str(tmp_path / "nope.raw"))
        try:
            assert _wait(lambda: not prod.running, 2.0)
            assert prod.error and prod.pushed == 0
        finally:
            prod.stop()

    def test_zmq_producer_receives_raw_stream(self):
        """A pyzmq PUB (a remote capture daemon) -> the native SUB thread ->
        ring -> RingSource."""
        zmq = pytest.importorskip("zmq")
        n, L, T = 2, 64, 4
        frames = self._frames(n, L, T, seed=2)
        ctx = zmq.Context()
        pub, endpoint = _pub_and_endpoint(zmq, ctx)
        ring = native.NativeBlockRing(16, (n + 1) * L * 2)
        prod = native.NativeProducer.zmq(ring, endpoint)
        try:
            time.sleep(0.4)   # the SUB joins
            pub.send(b"short")   # wrong size: ignored, not a crash
            for fr in frames:
                pub.send(fr.tobytes())
            assert _wait(lambda: prod.pushed == T)
            assert prod.rejected == 1 and prod.hdr_frames == 0
            src = RingSource(ring, n_channels=n, block_len=L, timeout_ms=1000)
            for i, fr in enumerate(frames):
                sig, ref, seqs = src.next_block()
                np.testing.assert_array_equal(ref, fr[0])
                np.testing.assert_array_equal(sig, fr[1:])
                assert (seqs == i + 1).all()
        finally:
            prod.stop()
            pub.close(0)
            ctx.term()

    def test_zmq_producer_header_frames_carry_per_channel_seqnums(self):
        """Header frames (capture_daemon --wire header): the native SUB
        thread parses the wire frame, pushes each channel's capture seqnum
        into its ring track and restores the u8 offset, so a daemon-side
        drop on one channel gaps exactly that channel. Frames of the wrong
        geometry are rejected."""
        zmq = pytest.importorskip("zmq")
        n, L, T = 2, 64, 5
        frames = self._frames(n, L, T, seed=4)
        block_bytes = (n + 1) * L * 2
        seq_rows, seqs = [], np.ones(n + 1, np.uint32)
        for t in range(T):
            seq_rows.append(seqs.copy())
            seqs = seqs + 1
            if t == 2:
                seqs[1] += 1   # signal channel 0 skips one capture block
        ctx = zmq.Context()
        pub, endpoint = _pub_and_endpoint(zmq, ctx)
        ring = native.NativeBlockRing(16, block_bytes, n_seq=n + 1)
        prod = native.NativeProducer.zmq(ring, endpoint)
        try:
            time.sleep(0.4)
            pub.send(b"\x00" * (block_bytes + 7))   # bad geometry
            nh, lh = block_bytes // 8, 4   # right payload size, wrong channel count
            pub.send(struct.pack("<IIII", 0, nh, lh, 0) + b"\x00" * (4 * nh + 2 * nh * lh))
            n2, l2 = 2 * (n + 1), L // 2   # right total, wrong channel split
            pub.send(struct.pack("<IIII", 0, n2, l2, 0) + b"\x00" * (4 * n2 + 2 * n2 * l2))
            for t, fr in enumerate(frames):
                pub.send(pack_frame(t, seq_rows[t], (fr ^ np.uint8(0x80)).view(np.int8)))
            assert _wait(lambda: prod.pushed == T)
            assert prod.hdr_frames == T and prod.rejected == 3
            src = RingSource(ring, n_channels=n, block_len=L, timeout_ms=1000)
            got = []
            for fr in frames:
                sig, ref, seqs_out = src.next_block()
                np.testing.assert_array_equal(ref, fr[0])   # offset restored
                np.testing.assert_array_equal(sig, fr[1:])
                got.append(seqs_out)
            d = np.diff(np.stack(got).astype(np.int64), axis=0)
            assert d[2, 0] == 2   # the injected gap, exactly here
            d[2, 0] = 1
            np.testing.assert_array_equal(d, np.ones_like(d))
        finally:
            prod.stop()
            pub.close(0)
            ctx.term()

    def test_zmq_producer_rejects_truncated_hostile_header(self):
        """A header claiming more bytes than the receive buffer holds is
        truncated by zmq_recv, which still returns the full size: the
        producer rejects it, and keeps taking good blocks."""
        zmq = pytest.importorskip("zmq")
        block_bytes = 16384
        ring = native.NativeBlockRing(16, block_bytes)
        ctx = zmq.Context()
        pub, endpoint = _pub_and_endpoint(zmq, ctx)
        prod = native.NativeProducer.zmq(ring, endpoint)
        try:
            time.sleep(0.4)
            nh, lh = 8192, 1   # payload == block_bytes; 49,168 B in all
            pub.send(struct.pack("<IIII", 0, nh, lh, 0) + b"\x00" * (4 * nh)
                     + b"\x7f" * (2 * nh * lh))
            assert _wait(lambda: prod.rejected == 1)
            assert prod.pushed == 0
            pub.send(b"\x80" * block_bytes)
            assert _wait(lambda: prod.pushed == 1)
        finally:
            prod.stop()
            pub.close(0)
            ctx.term()


class TestBuild:
    """The library builds itself at first use: g++ into
    ``build/native_host/`` by a hash of the source, the flags, the
    compiler and the CPU; a broken source raises with the compiler's
    output; only a missing compiler makes it unavailable."""

    def test_builds_from_the_port_source_into_build(self):
        assert native.available()
        path = native.library_path()
        root = native.SOURCE.parents[2]
        assert native.SOURCE == root / "coherent_rtlsdr_tpu_torch" / "csrc" / "coherent_host.cc"
        assert path.parent == root / "build" / "native_host" and path.exists()
        assert path.name.startswith("libcoherent_host_") and path.suffix == ".so"
        assert native.build() == path   # built once, then found

    def test_the_source_is_the_jax_package_copy(self):
        root = native.SOURCE.parents[2]
        assert native.SOURCE.read_bytes() == (root / "native" / "coherent_host.cc").read_bytes()
        assert native.CXX_FLAGS == ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
                                    "-Wextra")

    def test_compile_error_raises_with_the_compiler_output(self, tmp_path, monkeypatch):
        bad = tmp_path / "coherent_host.cc"
        bad.write_text(native.SOURCE.read_text() + "\nint broken( {\n")
        monkeypatch.setattr(native, "SOURCE", bad)
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(native, "_lib", None)
        with pytest.raises(RuntimeError, match="error") as err:
            native.available()
        assert not isinstance(err.value, native.NativeUnavailable)
        assert "coherent_host.cc" in str(err.value)
        assert not list((tmp_path / "build").iterdir())   # no partial library left

    def test_hash_follows_source_flags_and_host(self, tmp_path, monkeypatch):
        base = native.library_path()
        edited = tmp_path / "coherent_host.cc"
        edited.write_text(native.SOURCE.read_text() + "\n// edited\n")
        for name, value in (("SOURCE", edited), ("CXX_FLAGS", native.CXX_FLAGS + ("-g",)),
                            ("_host_key", lambda cxx: "another compiler and cpu")):
            with monkeypatch.context() as m:
                m.setattr(native, name, value)
                assert native.library_path() != base, name
        assert native.library_path() == base

    def test_no_compiler_means_unavailable(self, monkeypatch):
        monkeypatch.setenv("CXX", "no-such-compiler-xyz")
        monkeypatch.setattr(native, "_lib", None)
        assert native.available() is False
        with pytest.raises(native.NativeUnavailable):
            native.NativeBlockRing(4, 16)
        assert not native.rtlsdr_available()


class TestServerPublisher:
    """``io/server._make_publisher``: the native publisher first; pyzmq
    only without a compiler, without libzmq or for a port the OS picks; a
    bind failure raises."""

    def test_native_first_and_bind_failure_raises(self):
        pytest.importorskip("zmq")
        from coherent_rtlsdr_tpu_torch.io.server import _make_publisher

        data, debug = ipc_addr("srv-data"), ipc_addr("srv-debug")
        pub = _make_publisher(data, debug, header=True)
        try:
            assert isinstance(pub, native.NativePublisher)
            with pytest.raises(RuntimeError, match="could not bind"):
                _make_publisher(data, ipc_addr("srv-debug2"), header=True)
        finally:
            pub.close()

    def test_pyzmq_for_an_os_picked_port_or_no_compiler(self, monkeypatch):
        pytest.importorskip("zmq")
        from coherent_rtlsdr_tpu_torch.io.server import _make_publisher
        from coherent_rtlsdr_tpu_torch.io.zmq_edge import FramePublisher

        pub = _make_publisher("tcp://127.0.0.1:*", "tcp://127.0.0.1:*", header=True)
        assert isinstance(pub, FramePublisher)
        pub.close()
        monkeypatch.setenv("CXX", "no-such-compiler-xyz")
        monkeypatch.setattr(native, "_lib", None)
        pub = _make_publisher(ipc_addr("nocxx-data"), ipc_addr("nocxx-debug"), header=True)
        assert isinstance(pub, FramePublisher)
        pub.close()

    def test_broken_build_raises(self, tmp_path, monkeypatch):
        from coherent_rtlsdr_tpu_torch.io.server import _make_publisher

        bad = tmp_path / "coherent_host.cc"
        bad.write_text("#error broken\n")
        monkeypatch.setattr(native, "SOURCE", bad)
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(native, "_lib", None)
        with pytest.raises(RuntimeError, match="broken"):
            _make_publisher(ipc_addr("bad-data"), ipc_addr("bad-debug"), header=True)
