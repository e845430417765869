"""ctypes bindings for the native host-edge runtime
(``csrc/coherent_host.cc``, a copy of the JAX package's
``native/coherent_host.cc`` with the same C ABI).

The native library provides the C++ pieces the reference implements
natively: the capture block ring, the file / ZMQ / librtlsdr capture
threads that feed it, the wire-frame packetizer and ZMQ publisher (libzmq
loaded with ``dlopen``, so neither headers nor pyzmq are needed), and the
int8 conversion hot loops.

The library builds itself at first use: ``g++`` (or ``$CXX``) compiles the
source with the flags of the JAX package's ``native/Makefile`` into
``build/native_host/libcoherent_host_<hash>.so`` at the checkout root. The
hash covers the source, the flags, the compiler's version and the host
CPU's flags (``-march=native``), so a library built on another host is
never loaded. Each build writes a ``.<pid>.tmp`` file and renames it into
place, so processes that build at once never load a partial file. A failed
compile raises with the compiler's output; ``available()`` is False only
when no C++ compiler is found.
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "coherent_host.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native_host"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LINK_LIBS = ("-ldl", "-lpthread")
_lib = None
_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    """No C++ compiler was found to build the native library."""


class LibzmqUnavailable(RuntimeError):
    """The native library could not dlopen libzmq."""


def _compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    path = shutil.which(cxx)
    if path is None:
        raise NativeUnavailable(f"no C++ compiler to build {SOURCE.name}: '{cxx}' not found "
                                "(set CXX or put g++ on PATH)")
    return path


def _host_key(cxx: str) -> str:
    """The compiler's version and the host CPU's flags: what
    ``-march=native`` compiles for."""
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    cpu = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            cpu += next((line for line in f if line.startswith("flags")), "")
    except OSError:
        cpu += platform.processor()
    return version + cpu


def library_path(cxx: Optional[str] = None) -> Path:
    cxx = cxx or _compiler()
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_LIBS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_key(cxx).encode())
    return BUILD_DIR / f"libcoherent_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this host's build of this source is
    already there; returns its path. Raises ``NativeUnavailable`` without
    a compiler, and ``RuntimeError`` with the compiler's output when the
    compile fails."""
    cxx = _compiler()
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-shared", "-o", str(tmp), str(SOURCE), *LINK_LIBS]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} failed (exit {res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def _bind(lib):
    lib.chost_ring_create.restype = ctypes.c_void_p
    lib.chost_ring_create.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.chost_ring_create_seq.restype = ctypes.c_void_p
    lib.chost_ring_create_seq.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
    ]
    lib.chost_ring_nseq.restype = ctypes.c_uint32
    lib.chost_ring_nseq.argtypes = [ctypes.c_void_p]
    lib.chost_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.chost_ring_push.restype = ctypes.c_int64
    lib.chost_ring_push.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
    ]
    lib.chost_ring_push_n.restype = ctypes.c_int64
    lib.chost_ring_push_n.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint32,
    ]
    lib.chost_ring_pop.restype = ctypes.c_int
    lib.chost_ring_pop.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
    ]
    lib.chost_ring_pop_n.restype = ctypes.c_int
    lib.chost_ring_pop_n.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
    ]
    lib.chost_ring_dropped.restype = ctypes.c_uint64
    lib.chost_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.chost_ring_fill.restype = ctypes.c_uint32
    lib.chost_ring_fill.argtypes = [ctypes.c_void_p]
    lib.chost_requantize_i8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float,
    ]
    lib.chost_dequantize_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.chost_zmq_available.restype = ctypes.c_int
    lib.chost_pub_create.restype = ctypes.c_void_p
    lib.chost_pub_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.chost_pub_destroy.argtypes = [ctypes.c_void_p]
    lib.chost_pub_send.restype = ctypes.c_int64
    lib.chost_pub_send.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.chost_pub_gseq.restype = ctypes.c_uint32
    lib.chost_pub_gseq.argtypes = [ctypes.c_void_p]
    lib.chost_producer_file_start.restype = ctypes.c_void_p
    lib.chost_producer_file_start.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double, ctypes.c_int,
    ]
    lib.chost_producer_zmq_start.restype = ctypes.c_void_p
    lib.chost_producer_zmq_start.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.chost_producer_pushed.restype = ctypes.c_uint64
    lib.chost_producer_pushed.argtypes = [ctypes.c_void_p]
    lib.chost_producer_hdr_frames.restype = ctypes.c_uint64
    lib.chost_producer_hdr_frames.argtypes = [ctypes.c_void_p]
    lib.chost_producer_rejected.restype = ctypes.c_uint64
    lib.chost_producer_rejected.argtypes = [ctypes.c_void_p]
    lib.chost_producer_error.restype = ctypes.c_int
    lib.chost_producer_error.argtypes = [ctypes.c_void_p]
    lib.chost_producer_running.restype = ctypes.c_int
    lib.chost_producer_running.argtypes = [ctypes.c_void_p]
    lib.chost_producer_stop.argtypes = [ctypes.c_void_p]
    lib.chost_rtlsdr_load.restype = ctypes.c_int
    lib.chost_rtlsdr_load.argtypes = [ctypes.c_char_p]
    lib.chost_rtlsdr_available.restype = ctypes.c_int
    lib.chost_rtlsdr_device_count.restype = ctypes.c_int
    lib.chost_rtlsdr_device_serial.restype = ctypes.c_int
    lib.chost_rtlsdr_device_serial.argtypes = [
        ctypes.c_uint32, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.chost_rtlsdr_capture_start.restype = ctypes.c_void_p
    lib.chost_rtlsdr_capture_start.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
        ctypes.c_uint32,
    ]
    lib.chost_rtlsdr_capture_start_gains.restype = ctypes.c_void_p
    lib.chost_rtlsdr_capture_start_gains.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, ctypes.c_uint32,
    ]
    lib.chost_rtlsdr_capture_pushed.restype = ctypes.c_uint64
    lib.chost_rtlsdr_capture_pushed.argtypes = [ctypes.c_void_p]
    lib.chost_rtlsdr_capture_error.restype = ctypes.c_int
    lib.chost_rtlsdr_capture_error.argtypes = [ctypes.c_void_p]
    lib.chost_rtlsdr_capture_running.restype = ctypes.c_int
    lib.chost_rtlsdr_capture_running.argtypes = [ctypes.c_void_p]
    lib.chost_rtlsdr_capture_dropped.restype = ctypes.c_uint64
    lib.chost_rtlsdr_capture_dropped.argtypes = [ctypes.c_void_p]
    lib.chost_rtlsdr_capture_set_correction_f.restype = ctypes.c_int
    lib.chost_rtlsdr_capture_set_correction_f.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float,
    ]
    lib.chost_rtlsdr_capture_set_fcenter.restype = ctypes.c_int
    lib.chost_rtlsdr_capture_set_fcenter.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32,
    ]
    lib.chost_rtlsdr_capture_set_sample_rate.restype = ctypes.c_int
    lib.chost_rtlsdr_capture_set_sample_rate.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32,
    ]
    lib.chost_rtlsdr_capture_add.restype = ctypes.c_int
    lib.chost_rtlsdr_capture_add.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.chost_rtlsdr_capture_remove.restype = ctypes.c_int
    lib.chost_rtlsdr_capture_remove.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
    ]
    lib.chost_rtlsdr_capture_ndev.restype = ctypes.c_int
    lib.chost_rtlsdr_capture_ndev.argtypes = [ctypes.c_void_p]
    lib.chost_rtlsdr_capture_serial.restype = ctypes.c_int
    lib.chost_rtlsdr_capture_serial.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.chost_rtlsdr_capture_stalls.restype = ctypes.c_uint64
    lib.chost_rtlsdr_capture_stalls.argtypes = [ctypes.c_void_p]
    lib.chost_rtlsdr_capture_stop.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """True once the library is built and loaded. False only when no C++
    compiler is found: a failed compile raises."""
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


class NativeBlockRing:
    """SPSC block ring (owned-slot copies; no stale-buffer race class).

    ``n_seq > 1`` gives every slot that many seqnum tracks — one per capture
    channel (ref first), mirroring the reference's per-device ``readcnt``
    (src/crtlsdr.cc:181-188): a single channel's FIFO drop gaps only that
    channel's track. ``n_seq`` also sets the hot-add channel capacity of an
    rtlsdr capture bound to this ring (block_bytes = n_seq * 2 * block_len).
    """

    def __init__(self, nslots_pow2: int, block_bytes: int, n_seq: int = 1):
        lib = _load()
        self._lib = lib
        self._block_bytes = block_bytes
        self.n_seq = int(n_seq)
        self._ptr = lib.chost_ring_create_seq(nslots_pow2, block_bytes, n_seq)
        if not self._ptr:
            raise ValueError("nslots must be a power of two (and n_seq >= 1)")

    def push(self, block: np.ndarray, seqnum) -> int:
        b = np.ascontiguousarray(block).view(np.uint8).reshape(-1)
        assert b.nbytes == self._block_bytes, (b.nbytes, self._block_bytes)
        seqs = np.atleast_1d(np.asarray(seqnum, np.uint64))
        return self._lib.chost_ring_push_n(
            self._ptr, b.ctypes.data_as(ctypes.c_char_p),
            seqs.ctypes.data_as(ctypes.c_void_p), seqs.size,
        )

    def pop(self, timeout_ms: int = 0) -> Optional[Tuple[np.ndarray, int, int]]:
        out = np.empty(self._block_bytes, np.uint8)
        seq = ctypes.c_uint64()
        ts = ctypes.c_int64()
        ok = self._lib.chost_ring_pop(
            self._ptr, out.ctypes.data_as(ctypes.c_char_p),
            ctypes.byref(seq), ctypes.byref(ts), timeout_ms,
        )
        if not ok:
            return None
        return out, seq.value, ts.value

    def pop_n(
        self, timeout_ms: int = 0
    ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
        """Pop with ALL per-channel seqnum tracks: (block, seqs[n_seq], ts)."""
        out = np.empty(self._block_bytes, np.uint8)
        seqs = np.empty(self.n_seq, np.uint64)
        ts = ctypes.c_int64()
        ok = self._lib.chost_ring_pop_n(
            self._ptr, out.ctypes.data_as(ctypes.c_char_p),
            seqs.ctypes.data_as(ctypes.c_void_p), self.n_seq,
            ctypes.byref(ts), timeout_ms,
        )
        if not ok:
            return None
        return out, seqs, ts.value

    @property
    def dropped(self) -> int:
        return self._lib.chost_ring_dropped(self._ptr)

    @property
    def fill(self) -> int:
        return self._lib.chost_ring_fill(self._ptr)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.chost_ring_destroy(self._ptr)
            self._ptr = None


class NativePublisher:
    """Frame assembly + ZMQ PUB in native code (cpacketize::send analog)."""

    def __init__(self, data_addr: str, debug_addr: str = "", header: bool = True):
        lib = _load()
        if not lib.chost_zmq_available():
            raise LibzmqUnavailable("libzmq not found by native publisher")
        self._lib = lib
        self._ptr = lib.chost_pub_create(
            data_addr.encode(), debug_addr.encode(), 1 if header else 0
        )
        if not self._ptr:
            raise RuntimeError(f"could not bind {data_addr}")

    def publish(
        self,
        iq_i8: np.ndarray,            # [N, L, 2] int8
        seqnums: np.ndarray,          # [N] uint32
        phases: Optional[np.ndarray] = None,  # [N] complex64
    ) -> int:
        iq = np.ascontiguousarray(iq_i8, np.int8)
        n, l, _ = iq.shape
        seq = np.ascontiguousarray(seqnums, np.uint32)
        ph = (
            np.ascontiguousarray(phases, np.complex64).view(np.float32)
            if phases is not None
            else None
        )
        rc = self._lib.chost_pub_send(
            self._ptr, n, l,
            seq.ctypes.data_as(ctypes.c_void_p),
            iq.ctypes.data_as(ctypes.c_void_p),
            ph.ctypes.data_as(ctypes.c_void_p) if ph is not None else None,
        )
        if rc < 0:
            raise RuntimeError("zmq send failed")
        return int(rc)

    @property
    def globalseqn(self) -> int:
        return self._lib.chost_pub_gseq(self._ptr)

    def close(self):
        if getattr(self, "_ptr", None):
            self._lib.chost_pub_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()


class NativeProducer:
    """A native capture thread feeding a :class:`NativeBlockRing` — the
    reference's per-device async reader (src/crtlsdr.cc:44-59) as a C++
    thread. Two transports:

      * ``NativeProducer.file(ring, path, rate, loop)`` — replays a raw
        capture file of contiguous ring blocks, optionally paced to a block
        rate (simulating a live array's timing);
      * ``NativeProducer.zmq(ring, addr)`` — SUB-connects to a remote
        capture daemon (the czmqsdr stub's intent,
        include/csdrdevice.h:270-272). Accepts raw header-less blocks
        (reference -R mode, main.cc:105,148-150; a synthesized frame
        counter, gap-blind) AND seqnum-carrying header frames
        (apps/capture_daemon.py default): their per-channel capture
        seqnums land in the ring's per-channel tracks, so a daemon-side
        drop gaps exactly that channel in the remote pipeline — the
        reference's end-to-end readcnt semantics (cpacketizer.cc:142)
        preserved across the network hop.

    The ring owns backpressure: a full ring drops the block and counts it
    (the reference's documented under-load failure, README.md:42), which the
    pipeline's seqnum-gap detection then reports.
    """

    def __init__(self, ptr, ring):
        self._lib = _load()
        self._ptr = ptr
        self._ring = ring  # keep the ring alive while the thread runs

    @classmethod
    def file(cls, ring: "NativeBlockRing", path: str,
             rate_blocks_per_s: float = 0.0, loop: bool = False):
        lib = _load()
        ptr = lib.chost_producer_file_start(
            ring._ptr, path.encode(), float(rate_blocks_per_s), 1 if loop else 0
        )
        if not ptr:
            raise RuntimeError(f"could not start file producer for {path}")
        return cls(ptr, ring)

    @classmethod
    def zmq(cls, ring: "NativeBlockRing", addr: str):
        lib = _load()
        ptr = lib.chost_producer_zmq_start(ring._ptr, addr.encode())
        if not ptr:
            raise RuntimeError(f"could not start zmq producer for {addr}")
        return cls(ptr, ring)

    @property
    def pushed(self) -> int:
        if self._ptr is None:  # after stop(): the C object is freed
            return 0
        return self._lib.chost_producer_pushed(self._ptr)

    @property
    def hdr_frames(self) -> int:
        """Seqnum-carrying (header) frames received (zmq producer)."""
        if self._ptr is None:
            return 0
        return self._lib.chost_producer_hdr_frames(self._ptr)

    @property
    def rejected(self) -> int:
        """Messages dropped for wrong size/geometry (zmq producer)."""
        if self._ptr is None:
            return 0
        return self._lib.chost_producer_rejected(self._ptr)

    @property
    def running(self) -> bool:
        if self._ptr is None:
            return False
        return bool(self._lib.chost_producer_running(self._ptr))

    @property
    def error(self) -> bool:
        if self._ptr is None:
            return False
        return bool(self._lib.chost_producer_error(self._ptr))

    def stop(self):
        if getattr(self, "_ptr", None):
            self._lib.chost_producer_stop(self._ptr)
            self._ptr = None

    def __del__(self):
        self.stop()


def rtlsdr_load(path: Optional[str] = None) -> bool:
    """(Re)load librtlsdr — pass an explicit .so path (tests inject a mock),
    or None for the default search (env COHERENT_LIBRTLSDR, system names)."""
    lib = _load()
    return bool(lib.chost_rtlsdr_load(path.encode() if path else None))


def rtlsdr_available() -> bool:
    if not available():
        return False
    return bool(_load().chost_rtlsdr_available())


def rtlsdr_enumerate() -> list:
    """USB serial strings of all attached dongles (crtlsdr.cc:70-106)."""
    lib = _load()
    out = []
    for i in range(lib.chost_rtlsdr_device_count()):
        buf = ctypes.create_string_buffer(256)
        if lib.chost_rtlsdr_device_serial(i, buf, 256) >= 0:
            out.append(buf.value.decode())
    return out


class NativeRtlCapture:
    """Multi-dongle coherent USB capture into a :class:`NativeBlockRing` —
    the reference's thread-per-device librtlsdr path (src/crtlsdr.cc) as
    native C++ threads behind one handle. ``serials[0]`` is the REFERENCE
    channel (ring block layout: ref first, then signal channels — the
    RingSource contract).

    The open sequence per dongle follows the reference's order-sensitive
    recipe exactly (samplerate -> dithering OFF -> fcenter -> AGC -> gain
    mode/gain -> zero correction, src/crtlsdr.cc:112-135), and all dongles
    are released from a start barrier together (main.cc:252-258)."""

    def __init__(self, ring: "NativeBlockRing", serials, block_len: int,
                 fs: float = 2.048e6, fcenter: float = 1024e6,
                 gain_db: float = 50.0, ref_gain_db: float = 50.0,
                 agc: bool = False, asyncbufn: int = 8,
                 gains_db=None):
        """``gains_db``: optional per-dongle tuner gains (dB, reference
        first, one per serial; None entries fall back to gain_db/
        ref_gain_db) — the per-channel gain config the reference left as
        future work (examplecfg/four.cfg:4)."""
        lib = _load()
        self._lib = lib
        self._ring = ring
        self.serials = list(serials)
        if gains_db is not None:
            if len(gains_db) != len(self.serials):
                raise ValueError("gains_db must have one entry per serial")
            defaults = [ref_gain_db] + [gain_db] * (len(self.serials) - 1)
            tenths = [
                str(int(round((g if g is not None else d) * 10)))
                for g, d in zip(gains_db, defaults)
            ]
            ptr = lib.chost_rtlsdr_capture_start_gains(
                ring._ptr, ",".join(self.serials).encode(),
                ",".join(tenths).encode(), int(block_len),
                int(fs), int(fcenter), 1 if agc else 0, int(asyncbufn),
            )
        else:
            ptr = lib.chost_rtlsdr_capture_start(
                ring._ptr, ",".join(self.serials).encode(), int(block_len),
                int(fs), int(fcenter), int(round(gain_db * 10)),
                int(round(ref_gain_db * 10)), 1 if agc else 0, int(asyncbufn),
            )
        if not ptr:
            raise RuntimeError(
                "rtlsdr capture failed to start (librtlsdr missing, bad "
                "serial list, or ring block_bytes != n_serials * 2 * L)"
            )
        self._ptr = ptr

    @property
    def pushed(self) -> int:
        return self._lib.chost_rtlsdr_capture_pushed(self._ptr) if self._ptr else 0

    @property
    def running(self) -> bool:
        return bool(self._lib.chost_rtlsdr_capture_running(self._ptr)) \
            if self._ptr else False

    @property
    def error(self) -> int:
        return self._lib.chost_rtlsdr_capture_error(self._ptr) if self._ptr else 0

    @property
    def dropped(self) -> int:
        return self._lib.chost_rtlsdr_capture_dropped(self._ptr) if self._ptr else 0

    def set_correction_f(self, ch: int, ppm: float) -> int:
        """Skew one dongle's resampler (the reference control actuator,
        ccontrol.cc:78-123; requires the tejeez fork extension)."""
        if not self._ptr:
            return -1
        return self._lib.chost_rtlsdr_capture_set_correction_f(
            self._ptr, ch, float(ppm)
        )

    def set_fcenter(self, hz: float) -> int:
        """Retune all dongles (console `fcenter`, console.cc:176-201)."""
        if not self._ptr:
            return -1
        return self._lib.chost_rtlsdr_capture_set_fcenter(self._ptr, int(hz))

    def set_fs(self, hz: float) -> int:
        """Set the sample rate on all dongles while streaming (console `fs`
        semantics, console.cc:156-175; the caller forces a resync)."""
        if not self._ptr:
            return -1
        return self._lib.chost_rtlsdr_capture_set_sample_rate(
            self._ptr, int(hz)
        )

    def add(self, serial: str, gain_db: Optional[float] = None) -> int:
        """Hot-add a dongle (console `add`, console.cc:225-270). Returns the
        new capture channel index (>= 1; 0 is the reference) or a negative
        open rc. Needs a ring created with n_seq > current channel count."""
        if not self._ptr:
            return -1
        # 0xFFFFFFFF = "use the capture default" (0 is a real 0.0 dB gain)
        tenths = 0xFFFFFFFF if gain_db is None else int(round(gain_db * 10))
        rc = self._lib.chost_rtlsdr_capture_add(
            self._ptr, serial.encode(), tenths
        )
        if rc >= 0:
            self.serials = self.capture_serials()
        return rc

    def remove(self, serial: str) -> int:
        """Hot-remove a dongle (console `del`); returns its former capture
        index or -1. Remaining channels shift down one slot."""
        if not self._ptr:
            return -1
        rc = self._lib.chost_rtlsdr_capture_remove(self._ptr, serial.encode())
        if rc >= 0:
            self.serials = self.capture_serials()
        return rc

    def capture_serials(self) -> list:
        """Current channel->serial map straight from the native capture."""
        if not self._ptr:
            return []
        out = []
        for i in range(self._lib.chost_rtlsdr_capture_ndev(self._ptr)):
            buf = ctypes.create_string_buffer(256)
            if self._lib.chost_rtlsdr_capture_serial(self._ptr, i, buf, 256) >= 0:
                out.append(buf.value.decode())
        return out

    @property
    def stalls(self) -> int:
        """Frames abandoned because a device went silent for 200 ms (two-
        pass assembly consumed nothing — no silent channel skew)."""
        return self._lib.chost_rtlsdr_capture_stalls(self._ptr) if self._ptr else 0

    def stop(self):
        if getattr(self, "_ptr", None):
            self._lib.chost_rtlsdr_capture_stop(self._ptr)
            self._ptr = None

    def __del__(self):
        self.stop()


def requantize_i8(x: np.ndarray, scale: float = 127.0) -> np.ndarray:
    """float32 array -> int8 with saturation (native hot loop)."""
    lib = _load()
    xf = np.ascontiguousarray(x, np.float32)
    out = np.empty(xf.shape, np.int8)
    lib.chost_requantize_i8(
        xf.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        xf.size, scale,
    )
    return out


def dequantize_u8(x: np.ndarray) -> np.ndarray:
    """uint8 offset-binary -> float32 * 1/127 (native hot loop)."""
    lib = _load()
    xu = np.ascontiguousarray(x, np.uint8)
    out = np.empty(xu.shape, np.float32)
    lib.chost_dequantize_u8(
        xu.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        xu.size,
    )
    return out
