"""A cell of ``BENCHMARK.json`` shrunk to run on the CPU in a test: 3
channels at the cell's own block length (the plain versions of the port's
kernels at the cell's m), a short period, two captures of 16 blocks."""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

N = 3


def tiny_cell(name: str, bench=None):
    cell = harness.find_cell(bench or harness.load_benchmark(ROOT), name)
    cell.config = dict(cell.config, n_channels=N)
    L = cell.config["block_len"]
    tr = dict(cell.traffic)
    if tr["driver"] == "server":
        tr.update(period_samples=32 * L, warmup_blocks=8, sample_share=0.25)
    else:
        tr.update(capture_samples=16 * L, captures=2, sample_calls=2)
    cell.traffic = tr
    return cell


def execute(name: str, seconds: float = 0.5, trace: bool = False, seed: int = 2**31 + 5):
    """harness.execute of the tiny cell on the CPU: (result, run, values, checks)."""
    return harness.execute(tiny_cell(name), seed, seconds, trace, "cpu", time.perf_counter())
