"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the PyTorch
port (``coherent_rtlsdr_tpu_torch``). The run loads and warms up the cell
(``setup_s``), measures for ``--seconds``, compares what the timed path
produced with the plain reference (``portbench/reference``), and prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, ``breakdown`` (with
``--trace 1``) and ``checks``, each compared number beside its limit, which
also end standard error.

It exits non-zero and prints no result when there is no CUDA device, fewer
than the cell asks for, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# Every build and kernel cache at a fixed path inside the checkout. The
# port's own nvcc libraries go to build/torch_kernels/ there.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
sys.path.insert(0, str(ROOT))


def _power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _fail(msg: str, code: int):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _finite(v):
    return v if not (isinstance(v, float) and math.isinf(v)) else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device: this benchmark measures the port on the card only", 2)
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{cell.name} needs {cell.chips} devices, found {torch.cuda.device_count()}", 2)

    result, run, values, checks = harness.execute(cell, args.seed % 2**63, args.seconds,
                                                  bool(args.trace), "cuda:0", T_START)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": run.memory_peak_bytes,
        "power_limit_w": _power_limit_w(),
    }
    result = {**result, "device": device}
    breakdown = result.pop("breakdown", None)
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}

    loaded = sorted(set(run.forbidden) | set(harness.forbidden_loaded()))
    if loaded:
        _fail(f"modules that the benchmark may not load were loaded: {', '.join(loaded)}", 3)

    steps = " ".join(f"{name} {t:.3f}" for name, t in run.marks)
    print(f"portbench: steps (s from the start): {steps}; the window opened at "
          f"{run.setup_s:.3f}", file=sys.stderr)
    for k, v in values.items():
        if k not in checks:
            print(f"portbench: reading {k} = {v} (no limit)", file=sys.stderr)
    for k, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {k} {c['value']} limit {c['limit']} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
