"""Cells, configurations, mixes and metrics found by name; a new one added
by files and entries alone; the module graph of a run; a run without a card
or without the port."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import _tiny
from portbench import harness

ROOT = _tiny.ROOT
BENCH = harness.load_benchmark(ROOT)


def test_every_cell_config_mix_and_metric_is_found_by_name():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for m in names:
        assert callable(harness.reader(m))
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = harness.find_cell(BENCH, w["name"])
        assert hasattr(harness.driver(cell.traffic), "run")
        assert (harness.BENCH_DIR / "limits" / f"{w['name']}.json").exists()
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_a_new_cell_config_mix_and_metric_are_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "portbench/configs/rtlsdr21_b8192.json").read_text())
    cfg.update(name="rtlsdr7_b2048", n_channels=7, block_len=2048)
    (root / "portbench/configs/rtlsdr7_b2048.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/offline_small.json").write_text(json.dumps(
        dict(driver="offline", capture_samples=4 * 2048, captures=1, smoothing="global",
             max_ppm=0.1, in_flight=1, sample_calls=1)))
    (root / "portbench/metrics/calls_in_window.py").write_text(
        "def read(run):\n    return run.data.get('calls')\n")
    (root / "portbench/limits/b2048.offline_small.json").write_text(
        json.dumps({"wire_rms_lsb": 0.6}))
    bench["configs"].append(dict(name="rtlsdr7_b2048", source="test", reduced=[], why="test",
                                 file="portbench/configs/rtlsdr7_b2048.json"))
    bench["workloads"].append(dict(name="b2048.offline_small", config="rtlsdr7_b2048",
                                   traffic="offline_small", chips=1, why="test"))
    bench["per_layer"].append(dict(name="calls_in_window", unit="calls", better="higher",
                                   source="host_clock", layer="test",
                                   moves="offline_samples_per_s",
                                   workloads=["b2048.offline_small"]))
    next(m for m in bench["end_to_end"]
         if m["name"] == "offline_samples_per_s")["workloads"].append("b2048.offline_small")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    bench_dir = root / "portbench"
    cell = harness.find_cell(bench, "b2048.offline_small", root=root, bench_dir=bench_dir)
    assert cell.config["n_channels"] == 7 and cell.traffic["captures"] == 1
    assert [m["name"] for m in cell.per_layer] == ["calls_in_window"]
    import time

    res, run, values, checks = harness.execute(cell, 3, 0.3, False, "cpu", time.perf_counter(),
                                               bench_dir=bench_dir)
    assert res["correct"] and set(res["metrics"]) == {"offline_samples_per_s", "setup_s"}
    assert harness.read_metrics(cell.per_layer, run, bench_dir)["calls_in_window"]["value"] >= 1


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_loaded({"coherent_rtlsdr_tpu_torch": 1,
                                     "coherent_rtlsdr_tpu_torch.io": 1, "jaxtyping": 1}) == []
    assert harness.forbidden_loaded({"coherent_rtlsdr_tpu.io.wire": 1, "jax": 1,
                                     "flax.linen": 1}) == ["coherent_rtlsdr_tpu", "flax", "jax"]


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import _tiny\nfrom portbench import harness\n"
            "for w in ('b8192.offline', 'b8192.server_flood'):\n"
            "    _tiny.execute(w, seconds=0.2)\n"
            "print(harness.forbidden_loaded())\n") % (str(ROOT), str(Path(__file__).parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".")[0] in ("math", "json", "pathlib", "numpy", "torch",
                                             "portbench", ""), (path, mod)
                assert not mod.startswith("portbench.drivers"), (path, mod)


def _run_py(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "b8192.offline",
                           "--seed", "3", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_run_with_only_the_benchmark_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for w in BENCH["workloads"]:
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload", w["name"],
                              "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
                             cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"], out.stderr[-2000:]
