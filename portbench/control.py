"""The control of a cell's comparison: the plain reference computed one step
below the configuration's precision (fp8 transform operands, where the
configuration states bf16) put in the program's place, and compared with
the float64 reference as a run compares the program.

    python3 portbench/control.py --workload <name> --seeds 11 12 13 [--seconds 10]

prints one JSON line of readings a seed. A sound comparison fails the
control: its readings show where a cell's limits have to lie. The
benchmark's own runs never run this. On a served stream it follows the
blocks that a run of ``--seconds`` hands over (``--blocks`` sets their
number, warm-up included; by default the closed loop's 320 blocks/s at
L = 8192, scaled by the block length) and compares the frames that such a
run keeps.
"""

import argparse
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness, synth  # noqa: E402
from portbench.drivers import offline as offline_driver  # noqa: E402
from portbench.drivers import server as server_driver  # noqa: E402
from portbench.reference import align, compare  # noqa: E402

CLOSED_LOOP_BLOCKS_S = 320.0 * 8192


def stream_blocks(cell, seconds: float) -> int:
    rate = CLOSED_LOOP_BLOCKS_S / cell.config["block_len"]
    return cell.traffic["warmup_blocks"] + int(seconds * rate)


def stream_readings(cell, seed: int, n_blocks: int, device) -> dict:
    cfg, tr = cell.config, cell.traffic
    N, L = cfg["n_channels"], cfg["block_len"]
    P = tr["period_samples"] // L
    truth = synth.make_truth(N, seed=seed, max_delay=cfg["truth_max_delay"], snr_db=cfg["snr_db"])
    sig, ref = synth.render_periodic(seed, truth, P, L, cfg["amplitude"], device=device)
    p = align.Params(cfg)
    want = align.StreamReference(align.Transform(2 * L, device, "f64"), p, sig, ref)
    got = align.StreamReference(align.Transform(2 * L, device, "fp8"), p, sig, ref)
    want.follow(n_blocks)
    got.follow(n_blocks)
    keep = server_driver.sample_frames(seed, tr["warmup_blocks"], tr["sample_share"])
    frames = {g: got.frame(g) for g in sorted(keep) if g < n_blocks}
    r = compare.Readings()
    compare.stream(r, want, got.phases, frames)
    return r.values()


def offline_readings(cell, seed: int, device) -> dict:
    cfg, tr = cell.config, cell.traffic
    L = cfg["block_len"]
    T = tr["capture_samples"] // L
    p = align.Params(cfg)
    want_tf = align.Transform(2 * L, device, "f64")
    got_tf = align.Transform(2 * L, device, "fp8")
    r = compare.Readings()
    for c in range(tr["captures"]):
        sig, ref = offline_driver.render_capture(cell, seed, c, device)
        want = align.align_offline(want_tf, p, sig, ref)
        g = align.align_offline(got_tf, p, sig, ref)
        got = types.SimpleNamespace(lag=g["lag"], mag=g["mag"], wire=g["wire"],
                                    wire_ref=g["wire_ref"],
                                    delay=g["delay"].expand(T - 1, -1),
                                    phase=g["phase"].expand(T - 1, -1))
        compare.offline(r, got, want)
    return r.values()


def readings(cell, seed: int, seconds: float, device, n_blocks=None) -> dict:
    if cell.traffic["driver"] == "server":
        return stream_readings(cell, seed, n_blocks or stream_blocks(cell, seconds), device)
    return offline_readings(cell, seed, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--blocks", type=int, default=None)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        sys.exit(2)
    seconds = args.seconds or bench["run_seconds"]
    limits = compare.limits_for(harness.BENCH_DIR, cell.name)
    for seed in args.seeds:
        v = readings(cell, seed % 2**63, seconds, torch.device("cuda:0"), args.blocks)
        correct, _ = compare.judge(v, limits)
        print(json.dumps({"workload": cell.name, "seed": seed, "control_correct": correct,
                          "readings": v}), flush=True)


if __name__ == "__main__":
    main()
