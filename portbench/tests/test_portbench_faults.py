"""The comparison against a broken timed path and against the control, at a
size a test run holds: the harness drives a whole run of each cell on the
CPU (the port's plain kernel versions; the look for a card is skipped),
with the program broken underneath (``portbench/faults.py``), and
``correct`` has to come out false.

Faults, each where the cell can have it: the step returns its state
unchanged (the server cells); the smoother's mean taken over half of the
windows (the offline cells); an answer altered where it is produced (a
wire byte of the apply kernel's output, a reference-channel byte, a
seqnum). One chip is in scope: there is no exchange between chips to leave
out. The control is the reference one precision step down (fp8 operands).
"""

import pytest
import torch

import _tiny
from portbench import control, faults, harness
from portbench.reference import compare

SERVER_CELLS = ("b8192.server_flood",)
OFFLINE_CELLS = ("b8192.offline", "b32768.offline")


def _incorrect(name):
    res, _, values, checks = _tiny.execute(name)
    failed = [k for k, c in checks.items() if not c["value"] <= c["limit"]]
    return (not res["correct"]) and bool(failed), failed


@pytest.mark.parametrize("name", SERVER_CELLS + OFFLINE_CELLS)
def test_sound_run_is_correct(name):
    res, run, values, _ = _tiny.execute(name)
    assert res["correct"], values
    assert run.attempted > 0 and run.failed == 0


@pytest.mark.parametrize("name", SERVER_CELLS)
def test_step_returning_its_state_unchanged(name, monkeypatch):
    faults.frozen_state(monkeypatch.setattr)
    bad, failed = _incorrect(name)
    assert bad, failed


@pytest.mark.parametrize("name", OFFLINE_CELLS)
def test_mean_over_half_the_windows(name, monkeypatch):
    faults.half_windows(monkeypatch.setattr)
    bad, failed = _incorrect(name)
    assert bad and "delay_max" in failed, failed


@pytest.mark.parametrize("name", SERVER_CELLS + OFFLINE_CELLS)
def test_wire_byte_altered_where_it_is_produced(name, monkeypatch):
    faults.wire_byte(monkeypatch.setattr)
    bad, failed = _incorrect(name)
    assert bad and "wire_max_lsb" in failed, failed


@pytest.mark.parametrize("name", SERVER_CELLS)
def test_reference_byte_or_seqnum_altered(name, monkeypatch):
    faults.ref_byte_and_seqnum(monkeypatch.setattr)
    bad, failed = _incorrect(name)
    assert bad and {"ref_bytes_differ", "seq_errors"} <= set(failed), failed


@pytest.mark.parametrize("name", OFFLINE_CELLS)
def test_reference_channel_altered_offline(name, monkeypatch):
    faults.ref_channel_offline(monkeypatch.setattr)
    bad, failed = _incorrect(name)
    assert bad and "ref_bytes_differ" in failed, failed


def test_every_fault_is_tested_and_restorable():
    """Each fault that a driver lists is one of the above, and
    ``faults.Patches`` puts the port back."""
    from coherent_rtlsdr_tpu_torch.pipeline import offline

    tested = {"frozen_state", "half_windows", "wire_byte", "ref_byte_and_seqnum",
              "ref_channel_offline"}
    assert set().union(*(set(f) for f in faults.FAULTS.values())) == tested
    before = offline.smooth_delays
    p = faults.Patches()
    faults.half_windows(p)
    assert offline.smooth_delays is not before
    p.undo()
    assert offline.smooth_delays is before


@pytest.mark.parametrize("name", SERVER_CELLS + OFFLINE_CELLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 7])
def test_control_fails(name, seed):
    """The reference at fp8 operands in the program's place is not correct."""
    cell = _tiny.tiny_cell(name)
    v = control.readings(cell, seed, 0.5, torch.device("cpu"), n_blocks=120)
    correct, checks = compare.judge(v, compare.limits_for(harness.BENCH_DIR, name))
    assert not correct, checks
