"""Faults planted in the port underneath a whole run of a cell: each has to
turn ``correct`` false where the cell can have it.

    python3 portbench/faults.py --workload <name> --fault <fault> --seeds 11 12 13 [--seconds 3]

runs the cell on the card at its own size, with the fault planted (``none``
plants nothing: the program's own readings), once a seed in one process,
and prints one JSON line a seed: ``correct``, the numbers that failed their
limits, and every reading. ``tests/test_portbench_faults.py`` drives the
same faults through runs on the CPU. The benchmark's own runs never load
this module.

Each fault takes ``patch(owner, name, value)``, which sets an attribute of
the port for the run (pytest's ``monkeypatch.setattr``, or :class:`Patches`).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def frozen_state(patch):
    """The server's step returns its state unchanged."""
    from coherent_rtlsdr_tpu_torch.io import server

    make = server.make_packed_step

    def frozen(cfg):
        step = make(cfg)

        def run(pstate, *a):
            _, wire, wire_ref, telem = step(pstate, *a)
            return pstate, wire, wire_ref, telem

        return run

    patch(server, "make_packed_step", frozen)


def half_windows(patch):
    """The offline smoother takes its mean over the first half of the
    windows, and applies it to all of them."""
    from coherent_rtlsdr_tpu_torch.pipeline import offline

    smooth = offline.smooth_delays

    def half(cfg, lag, mag, smoothing, time=offline.WHOLE_CAPTURE):
        n = lag.shape[0] // 2
        return smooth(cfg, lag[:n], mag[:n], smoothing, time)[:1].expand(lag.shape)

    patch(offline, "smooth_delays", half)


def wire_byte(patch):
    """One wire byte of each window altered in the apply kernel's output."""
    from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels

    apply = FusedPipelineKernels.apply_spec_i8

    def altered(self, *a):
        out = apply(self, *a).clone()
        out[..., 0, 0] ^= 0x40
        return out

    patch(FusedPipelineKernels, "apply_spec_i8", altered)


def ref_byte_and_seqnum(patch):
    """A reference-channel byte and every seqnum altered where the server
    publishes."""
    from coherent_rtlsdr_tpu_torch.io import server

    publish = server.CoherentServer._publish_batch

    def altered(self, wire_sigs, wire_refs, telem, ready, seqnums, **kw):
        wire_refs = wire_refs.clone()
        wire_refs.view(-1)[7] += 1
        seqnums = [s + 1 for s in seqnums]
        return publish(self, wire_sigs, wire_refs, telem, ready, seqnums, **kw)

    patch(server.CoherentServer, "_publish_batch", altered)


def ref_channel_offline(patch):
    """A reference-channel byte altered in ``align_offline``'s output."""
    from coherent_rtlsdr_tpu_torch.pipeline import offline

    align = offline.align_offline

    def altered(*a, **kw):
        out = align(*a, **kw)
        out.wire_ref = out.wire_ref.clone()
        out.wire_ref[..., 3] += 1
        return out

    patch(offline, "align_offline", altered)


# The faults that a cell of each driver can have.
FAULTS = {
    "server": {"frozen_state": frozen_state, "wire_byte": wire_byte,
               "ref_byte_and_seqnum": ref_byte_and_seqnum},
    "offline": {"half_windows": half_windows, "wire_byte": wire_byte,
                "ref_channel_offline": ref_channel_offline},
}


class Patches:
    """``patch(owner, name, value)`` that :meth:`undo` reverses."""

    def __init__(self):
        self.saved = []

    def __call__(self, owner, name, value):
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self.saved:
            owner, name, value = self.saved.pop()
            setattr(owner, name, value)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload)
    faults = FAULTS[cell.traffic["driver"]]
    if args.fault != "none" and args.fault not in faults:
        ap.error(f"{cell.name} can have {sorted(faults)} (or none), not {args.fault!r}")
    if not torch.cuda.is_available():
        print("faults: no CUDA device", file=sys.stderr)
        sys.exit(2)
    patches = Patches()
    if args.fault != "none":
        faults[args.fault](patches)
    try:
        for seed in args.seeds:
            res, run, values, checks = harness.execute(cell, seed % 2**63, args.seconds, False,
                                                       "cuda:0", time.perf_counter())
            failed = sorted(k for k, c in checks.items() if not c["value"] <= c["limit"])
            print(json.dumps({"workload": cell.name, "fault": args.fault, "seed": seed,
                              "correct": res["correct"], "failed": failed,
                              "attempted": res["attempted"], "readings": values}), flush=True)
    finally:
        patches.undo()


if __name__ == "__main__":
    main()
