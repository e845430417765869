"""What ``run.py`` finds by name: the cell, its configuration, its traffic
mix, its metrics and their readers, and the limits of its comparison.

``BENCHMARK.json`` names each cell's configuration (``configs/<name>.json``
through the configuration's ``file``) and traffic mix
(``traffic/<mix>.json``). The mix names the driver that runs it
(``drivers/<driver>.py``, a module with ``run(run)`` returning the readings), and each
metric is read by ``metrics/<metric name>.py`` (a module with ``read(run) ->
float | None``). The comparison's limits are ``limits/<cell>.json``. A cell,
a configuration, a mix or a metric is added by adding files and entries.
"""

import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
import types
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# Loaded in the process that prints a result, these stop the run: the
# benchmark measures the PyTorch port alone. Compared by whole top-level names.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "coherent_rtlsdr_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict      # the configuration file's contents
    traffic_name: str
    traffic: dict     # the traffic file's contents
    end_to_end: list  # the metric entries this cell reports with --trace 0
    per_layer: list   # ... and with --trace 1


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reported_in(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if ("workloads" in m and name in m["workloads"])
             or ("workloads" not in m and m["moves"] in e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, end_to_end=e2e, per_layer=layer)


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic: dict, bench_dir: Path = BENCH_DIR):
    """The driver module that runs a traffic mix (``drivers/<driver>.py``)."""
    name = traffic["driver"]
    return _load_file(bench_dir / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def reader(metric_name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<metric_name>.py``."""
    mod = _load_file(bench_dir / "metrics" / f"{metric_name}.py",
                     "portbench_metric_" + metric_name.replace(".", "_").replace("-", "_"))
    return mod.read


def forbidden_loaded(modules=None) -> list:
    """The top-level names in ``sys.modules`` that the benchmark may not load."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def read_metrics(entries: list, run, bench_dir: Path = BENCH_DIR) -> dict:
    """``{name: {"value", "unit"}}`` of each metric whose reader finds
    something to read."""
    out = {}
    for m in entries:
        v: Optional[float] = reader(m["name"], bench_dir)(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


class Run:
    """One run of one cell: what the driver is given, and what it and the
    trace leave for the metric readers (``data``, ``trace``, ``setup_s``)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float):
        import torch

        self.cell, self.seed, self.seconds, self.trace_on = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.setup_s = None
        self.trace = None
        self.data = {}
        self.attempted = self.failed = 0
        self.memory_peak_bytes = 0
        self.forbidden = []
        self.marks = []       # (name, seconds since the start) of the run's steps

    def mark(self, name: str) -> None:
        """Stamp the end of a step of the run, for its report."""
        self.marks.append((name, time.perf_counter() - self.t_start))

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_memory(self) -> None:
        """Start the peak from here: what set-up rendered and freed is the
        benchmark's, not the program's."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    def read_memory(self) -> None:
        """The peak of the window, and the modules loaded by then."""
        import torch

        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))
        self.forbidden = forbidden_loaded()

    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends where it starts; under
        ``--trace 1`` the profiler covers it."""
        from portbench.trace import Trace

        self.sync()
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_start
        with Trace(self.trace_on, self.device.type == "cuda") as tr:
            self.sync()
            win = types.SimpleNamespace(t0=time.perf_counter())
            with tr.window():
                yield win
            self.mark("window end")
        self.trace = tr.summary()


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            bench_dir: Path = BENCH_DIR):
    """Run the cell once on ``device``: (result without ``device``, the run,
    the readings, the checks). The result holds ``correct``, ``attempted``,
    ``failed``, ``metrics`` and, when traced, ``breakdown``."""
    from portbench.reference import compare

    run = Run(cell, seed, seconds, trace, device, t_start)
    run.mark("imports")
    run.sync()
    run.mark("device")
    values = driver(cell.traffic, bench_dir).run(run)
    run.mark("compared")
    correct, checks = compare.judge(values, compare.limits_for(bench_dir, cell.name))
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, run, bench_dir)
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics}
    if trace and run.trace is not None:
        result["breakdown"] = run.trace["breakdown"]
    return result, run, values, checks
