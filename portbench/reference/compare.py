"""The numbers that decide ``correct``: what the timed path produced against
the plain reference (``align.py``), and each number's limit.

Each reading is the worst over everything compared: the widest gap of a
scalar, the RMS and the widest gap of the wire bytes in LSB, and counts of
what must be exact (the reference channel's bytes, the seqnums, frames that
never came). A limit file holds the limit of each number that a cell
compares; a reading with no limit is not compared.
"""

import json
import math
from pathlib import Path

import numpy as np
import torch


class Readings:
    """Accumulates the worst gaps over everything compared."""

    def __init__(self):
        self.max = {}
        self.counts = {}
        self._sq, self._n = 0.0, 0

    def worst(self, name: str, value: float) -> None:
        self.max[name] = max(self.max.get(name, 0.0), float(value))

    def count(self, name: str, n: int) -> None:
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def wire(self, got: torch.Tensor, want: torch.Tensor) -> None:
        """int8 wire samples of the program against the reference's."""
        d = got.reshape(-1).to(torch.int32) - want.reshape(-1).to(torch.int32)
        self._sq += float((d.to(torch.float64) ** 2).sum())
        self._n += d.numel()
        self.worst("wire_max_lsb", int(d.abs().max()) if d.numel() else 0)

    def scalar(self, name: str, got, want) -> None:
        gap = torch.as_tensor(got, dtype=torch.float64) - torch.as_tensor(want, dtype=torch.float64)
        self.worst(name, float(gap.abs().max()))

    def rms(self, name: str, got, want) -> None:
        """The RMS gap of one compared output; the worst over outputs."""
        gap = torch.as_tensor(got, dtype=torch.float64) - torch.as_tensor(want, dtype=torch.float64)
        self.worst(name, float(torch.sqrt((gap ** 2).mean())))

    def phase(self, got, want) -> None:
        """Phase factors (complex) of the program against the reference's, in
        degrees."""
        got = torch.as_tensor(got).to(torch.complex128)
        want = torch.as_tensor(want).to(torch.complex128).to(got.device)
        self.worst("phase_max_deg", math.degrees(float(torch.angle(got * want.conj()).abs().max())))

    def values(self) -> dict:
        out = dict(self.counts)
        out.update(self.max)
        if self._n:
            out["wire_rms_lsb"] = math.sqrt(self._sq / self._n)
        return out


def offline(r: Readings, got, want: dict) -> None:
    """One ``align_offline`` result (its lag, mag, delay, phase, wire and
    wire_ref) against the reference's."""
    dev = got.lag.device
    r.scalar("lag_max", got.lag, want["lag"].to(dev))
    r.rms("lag_rms", got.lag, want["lag"].to(dev))
    r.scalar("mag_max", got.mag, want["mag"].to(dev))
    r.scalar("delay_max", got.delay, want["delay"].to(dev).expand_as(got.delay))
    r.phase(got.phase, want["phase"].expand_as(got.phase))
    r.wire(got.wire, want["wire"].to(dev))
    r.count("ref_bytes_differ", int((got.wire_ref.reshape(-1)
                                     != want["wire_ref"].to(dev).reshape(-1)).sum()))


def stream(r: Readings, want, phases: np.ndarray, frames: dict) -> None:
    """A served stream against the reference's (``align.StreamReference``
    after its ``follow``): the applied phase factors of every frame
    ``[G, N]``, and the int8 frames ``{g: [N + 1, L, 2]}`` kept, reference
    channel first."""
    if len(phases):
        r.phase(torch.from_numpy(np.asarray(phases)), torch.from_numpy(want.phases[: len(phases)]))
    for g, iq in sorted(frames.items()):
        w = want.frame(g)
        got = torch.as_tensor(iq).to(w.device)
        r.count("ref_bytes_differ", int((got[0] != w[0]).sum()))
        r.wire(got[1:], w[1:])
    r.count("frames_compared", len(frames))


def limits_for(bench_dir: Path, workload: str) -> dict:
    path = bench_dir / "limits" / f"{workload}.json"
    return json.loads(path.read_text())


def judge(values: dict, limits: dict):
    """(correct, checks): every number with a limit, ``{name: {"value",
    "limit"}}``; correct when each is at most its limit. A number that a run
    did not read counts as failed."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = values.get(name, float("inf"))
        if isinstance(v, float) and not np.isfinite(v):
            v = float("inf")
        checks[name] = {"value": v, "limit": limit}
        ok = ok and v <= limit
    return ok, checks
