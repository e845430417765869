"""The port's host edge against the JAX package's, on the same inputs (CPU):
the packed state at the host edge, the wire format, the console grammar,
config files, capture files, the telemetry ring and the refnoise switch.
The port keeps copies of the JAX package's jax-free modules; these tests
hold the copies to the originals. Every comparison here is exact (equal
bytes, replies, arrays)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.io import config as jconfig
from coherent_rtlsdr_tpu.io import console as jconsole
from coherent_rtlsdr_tpu.io import streamio as jstreamio
from coherent_rtlsdr_tpu.io import wire as jwire
from coherent_rtlsdr_tpu.pipeline import state as jstate
from coherent_rtlsdr_tpu.utils import telemetry as jtelemetry
from coherent_rtlsdr_tpu_torch.io import config as tconfig
from coherent_rtlsdr_tpu_torch.io import console as tconsole
from coherent_rtlsdr_tpu_torch.io import streamio as tstreamio
from coherent_rtlsdr_tpu_torch.io import wire as twire
from coherent_rtlsdr_tpu_torch.io.refnoise import RefNoise
from coherent_rtlsdr_tpu_torch.pipeline import state as tstate
from coherent_rtlsdr_tpu_torch.utils import telemetry as ttelemetry


def _leaves(rng, n=3, fused=True):
    """Random PipelineState leaves as numpy arrays in the JAX dtypes."""
    hist_shape = (n, 32, 128) if fused else (n, 64, 2)
    hist_dtype = np.int8 if fused else np.float32
    hist = (rng.integers(-128, 128, hist_shape) if fused
            else rng.standard_normal(hist_shape)).astype(hist_dtype)
    phase = rng.standard_normal((n, 2)).astype(np.float32)
    return dict(
        delay=rng.standard_normal(n).astype(np.float32), phase=phase,
        lag=rng.standard_normal(n).astype(np.float32),
        mag=rng.random(n).astype(np.float32), papr=rng.random(n).astype(np.float32),
        synced=rng.random(n) < 0.5, hist=hist, ref_hist=hist[0].copy(),
        block_idx=np.int32(rng.integers(0, 1 << 20)),
        last_seq=rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        gaps=rng.integers(0, 9, n).astype(np.int32),
    )


@pytest.mark.parametrize("fused", [True, False])
def test_pack_state_host_round_trip_and_matches_jax(fused):
    """pack_state_host / unpack_state_host: an exact round trip, the same
    three tensors and the same view as the JAX package's on the same
    leaves; torch and numpy leaves mixed give the same tensors."""
    rng = np.random.default_rng(5 if fused else 6)
    leaves = _leaves(rng, fused=fused)
    packed = tstate.pack_state_host(tstate.PipelineState(**leaves), "cpu")
    jpacked = jstate.pack_state_host(jstate.PipelineState(**leaves))
    for t, j in zip(packed, jpacked):
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    view = tstate.unpack_state_host(*packed)
    jview = jstate.unpack_state_host(*jpacked)
    for name, a in leaves.items():
        got = getattr(view, name)
        assert isinstance(got, np.ndarray) or np.isscalar(got), name
        assert np.asarray(got).dtype == np.asarray(a).dtype, name
        np.testing.assert_array_equal(got, a, err_msg=name)
        np.testing.assert_array_equal(got, np.asarray(getattr(jview, name)), err_msg=name)
    # A view edited with dataclasses.replace rides straight back; torch
    # leaves (the port's own int64 last_seq carrier) mix with numpy ones.
    edited = dataclasses.replace(view, synced=np.zeros_like(view.synced),
                                 last_seq=torch.from_numpy(view.last_seq.astype(np.int64)),
                                 delay=torch.from_numpy(view.delay))
    again = tstate.pack_state_host(edited, "cpu")
    np.testing.assert_array_equal(again[1][:, 0].numpy(), 0)
    np.testing.assert_array_equal(again[1][:, 1:].numpy(), packed[1][:, 1:].numpy())
    for a, b in ((again[0], packed[0]), (again[2], packed[2])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # The view's leaves are copies: editing one leaves the packed state.
    view.delay[:] = 99.0
    np.testing.assert_array_equal(packed[0][:, 0].numpy(), leaves["delay"])
    # unpack_state (the device-side twin) agrees with the host view.
    dev = tstate.unpack_state(*packed)
    np.testing.assert_array_equal(dev.last_seq.numpy(), leaves["last_seq"].astype(np.int64))


def test_wire_frames_match_jax():
    rng = np.random.default_rng(0)
    iq = rng.integers(-128, 128, (4, 64, 2)).astype(np.int8)
    seqs = np.array([7, 8, 9, 2**32 - 1], np.uint32)
    for header in (True, False):
        tb = twire.pack_frame(2**32 + 5, seqs, iq, header=header)
        assert tb == jwire.pack_frame(2**32 + 5, seqs, iq, header=header)
        kw = {} if header else dict(n_channels=4, block_len=64)
        tf = twire.unpack_frame(tb, header=header, **kw)
        jf = jwire.unpack_frame(tb, header=header, **kw)
        for a, b in zip(tf, jf):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(twire.frame_to_matrix(tf), jwire.frame_to_matrix(jf))
    ph = (rng.standard_normal(4) + 1j * rng.standard_normal(4)).astype(np.complex64)
    assert twire.pack_debug(ph) == jwire.pack_debug(ph)
    np.testing.assert_array_equal(twire.unpack_debug(twire.pack_debug(ph)), ph)
    assert twire.frame_length(4, 64) == jwire.frame_length(4, 64)
    with pytest.raises(ValueError):
        twire.unpack_frame(tb[:-3])


class _FakeController:
    """Records every call; replies are functions of the state alone."""

    def __init__(self):
        self.log = []
        self.fs, self.fc, self.refnoise = 2.048e6, 1024e6, True

    def get_fs(self):
        return self.fs

    def set_fs(self, v):
        self.log.append(("fs", v))
        self.fs = v

    def get_fcenter(self):
        return self.fc

    def set_fcenter(self, v):
        self.log.append(("fcenter", v))
        self.fc = v

    def status(self):
        return "0 / 4 synchronized"

    def list_channels(self, all=False):
        return "ALL" if all else "SOME"

    def phase_table(self):
        return "0\t1\t2"

    def set_refnoise(self, v):
        self.log.append(("refnoise", v))

    def request_lag(self):
        self.log.append(("lag",))

    def request_sync(self):
        self.log.append(("sync",))

    def add_channel(self, s):
        return f"added {s}"

    def del_channel(self, s):
        return f"deleted {s}"

    def drain_log(self):
        return "logs"

    def shutdown(self):
        self.log.append(("quit",))


COMMANDS = [
    "help", "fs", "fs 1024000", "fs banana", "fs -1e99", "fs nan", "fcenter",
    "fcenter 868000000", "fcenter 0", "fcenter nan", "fcenter 999999999999",
    "status", "list", "list all", "phase", "log", "add NEW", "del SYN 1", "request re",
    "request rd", "request lag", "request sync", "request wat", "request", "",
    " ", "\x00\xff\xfe", "A" * 4096, "nop nop", "garbage xyz", "quit",
]


def test_console_replies_match_jax():
    """One command list, garbage included, through both dispatchers on fake
    controllers: the same replies and the same controller calls."""
    tc, jc = _FakeController(), _FakeController()
    td, jd = tconsole.ConsoleDispatcher(tc), jconsole.ConsoleDispatcher(jc)
    for line in COMMANDS:
        assert td.dispatch(line) == jd.dispatch(line), line
    assert tc.log == jc.log and len(tc.log) > 5
    assert tconsole.HELP_TEXT == jconsole.HELP_TEXT
    assert tconsole.parse_command("fcenter 1e6").options == "1e6"


def test_read_config_matches_jax(tmp_path):
    text = "# comment\nR :'M REF' gain=32.5\n1 :'M 1'\n2 :'M 2' gain=40\n10:'M 10'\n"
    path = tmp_path / "four.cfg"
    path.write_text(text)
    tdefs, jdefs = tconfig.read_config(str(path)), jconfig.read_config(str(path))
    assert [dataclasses.astuple(d) for d in tdefs] == [dataclasses.astuple(d) for d in jdefs]
    assert tconfig.get_refname(tdefs) == jconfig.get_refname(jdefs) == "M REF"
    assert ([d.devindex for d in tconfig.signal_channels(tdefs)]
            == [d.devindex for d in jconfig.signal_channels(jdefs)] == [1, 2, 10])


def test_telemetry_recorder_matches_jax():
    """The same series (a width change included) give the same history,
    drift statistic and counts."""
    rng = np.random.default_rng(2)
    tr, jr = ttelemetry.TelemetryRecorder(window=16), jtelemetry.TelemetryRecorder(window=16)
    for i in range(24):
        n = 3 if i < 20 else 4
        ph = np.exp(1j * rng.normal(0.0, 0.1, n)).astype(np.complex64)
        lag = rng.standard_normal(n)
        for r in (tr, jr):
            r.record(phase=ph, lag=lag)
    for name in ("phase", "lag"):
        np.testing.assert_array_equal(tr.history(name), jr.history(name))
        assert tr.n_recorded(name) == jr.n_recorded(name) == 4
    assert tr.phase_drift_deg_rms() == jr.phase_drift_deg_rms()
    np.testing.assert_array_equal(tr.last("lag"), jr.last("lag"))
    tr.clear()
    assert tr.n_recorded("phase") == 0 and np.isnan(tr.phase_drift_deg_rms())


def test_capture_files_match_jax(tmp_path):
    """A capture saved by the port loads in the JAX package and back, and
    the gap detector agrees."""
    rng = np.random.default_rng(3)
    seqs = np.cumsum(1 + (rng.random((6, 3)) < 0.2), axis=0).astype(np.uint32)
    cap = tstreamio.Capture(sig_u8=rng.integers(0, 256, (6, 3, 32, 2), dtype=np.uint8),
                            ref_u8=rng.integers(0, 256, (6, 32, 2), dtype=np.uint8),
                            seqnums=seqs, fs=2.048e6, fcenter=868e6)
    path = str(tmp_path / "cap.npz")
    tstreamio.save_capture(path, cap)
    back = jstreamio.load_capture(path)
    for name in ("sig_u8", "ref_u8", "seqnums"):
        np.testing.assert_array_equal(getattr(back, name), getattr(cap, name))
    assert (back.fs, back.fcenter, back.n_blocks) == (cap.fs, cap.fcenter, 6)
    np.testing.assert_array_equal(tstreamio.detect_seqnum_gaps(seqs),
                                  jstreamio.detect_seqnum_gaps(seqs))


def test_refnoise_char_protocol(tmp_path):
    """Simulation mode tracks the flag; on a device the host writes 'x' /
    'o' (noise on / off) and 'F' / 'f' (fan)."""
    rn = RefNoise(device=None)
    assert rn.isenabled
    rn.set_state(False)
    assert not rn.isenabled
    rn.close()
    dev = tmp_path / "ttyACM0"
    dev.write_bytes(b"")
    rn = RefNoise(device=str(dev), enable_on_open=True)
    rn.set_state(False)
    rn.set_fan(True)
    rn.set_fan(False)
    rn.close()
    assert dev.read_bytes() == b"xoFf"


def test_pack_state_host_uploads_from_jax_arrays():
    """The JAX package's own device-array leaves (a JAX checkpoint's view)
    pack the same as their numpy copies."""
    leaves = _leaves(np.random.default_rng(9))
    jleaves = {k: jnp.asarray(v) for k, v in leaves.items()}
    a = tstate.pack_state_host(tstate.PipelineState(**leaves), "cpu")
    b = tstate.pack_state_host(tstate.PipelineState(**jleaves), "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
