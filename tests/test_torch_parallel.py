"""The port's ``parallel/`` against the JAX package's, on the same bytes.

Each runner runs in gloo ranks on the CPU, one process a rank
(``tests/_torch_dist_child.py``, at most four a test, joined through a
FileStore under ``tmp_path``); this process runs the JAX sharded runner on
the 8-virtual-device CPU mesh (``tests/conftest.py``) at the same mesh shape
and the JAX unsharded engine, and holds every rank's output shard to the
matching slice by ``tests/test_parallel.py``'s bars: delay 1e-3 (generic) /
1e-4 (fused and four-step) samples, mag 1e-5, aligned 1e-3, fused wire
within 1 LSB, the truth within 0.05 / 0.1 samples. ``gather_to_rank0``'s
arrays must equal the shards put together. Also: ``auto_mesh_shape`` equal
to JAX's, the refusals, the imports, and ``apps/align_offline.py --mesh 2``
against the JAX app.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu import parallel as jpar
from coherent_rtlsdr_tpu import pipeline as jpipe
from coherent_rtlsdr_tpu.ops.convert import c64_to_i8_iq as jax_c64_to_i8_iq
from coherent_rtlsdr_tpu.parallel.mesh import auto_mesh_shape as jax_auto_mesh_shape
from coherent_rtlsdr_tpu.signal import make_truth, synth_capture
from coherent_rtlsdr_tpu_torch.apps import align_offline as align_app
from coherent_rtlsdr_tpu_torch.io.streamio import Capture, save_capture
from coherent_rtlsdr_tpu_torch.parallel import sharded
from coherent_rtlsdr_tpu_torch.parallel.mesh import auto_mesh_shape, make_mesh
from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig

REPO = Path(__file__).resolve().parents[1]
CHILD = REPO / "tests" / "_torch_dist_child.py"
RANK_TIMEOUT_S = 120
# The app's ranks run at the children's low priority (tests/_torch_dist_child.py).
NICE = ["nice", "-n", "10"]
APP = [sys.executable, "-m", "coherent_rtlsdr_tpu_torch.apps.align_offline"]
L, LF = 1024, 2048   # generic; fused and four-step (2L = 64^2)
FUSED = dict(fft_impl="fused", lag_method="phase_zoom")


def _capture(n_channels, n_blocks, seed, block_len, max_delay=30.0):
    truth = make_truth(n_channels, seed=seed, max_delay=max_delay, snr_db=30.0)
    cap = synth_capture(jax.random.PRNGKey(seed), truth, n_blocks=n_blocks,
                        block_len=block_len)
    return truth, np.asarray(cap.sig_u8), np.asarray(cap.ref_u8)


def _run_ranks(tmp_path, spec, sig, ref):
    """Run ``spec`` in t * c gloo ranks on ``sig`` / ``ref`` (numpy).
    Returns (each rank's outputs, rank 0's gathered outputs, each rank's
    refusals), ranks in mesh order."""
    world = spec["mesh"][0] * spec["mesh"][1]
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    np.savez(tmp_path / "in.npz", sig=sig, ref=ref)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(CHILD), str(tmp_path), str(r), str(world)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    shards = [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(world)]
    refusals = [json.loads((tmp_path / f"refusals_{r}.json").read_text()) for r in range(world)]
    return shards, dict(np.load(tmp_path / "gathered.npz")), refusals


def _rank_slices(mesh, T, N, windows_dropped=0):
    """(time, channel) slices of each rank's shard in the global output,
    ranks in mesh order; ``windows_dropped`` leading windows of time shard 0
    are not emitted (the auto runner's T - 1 outputs)."""
    t, c = mesh
    out = []
    for ti in range(t):
        lo = max(ti * T // t - windows_dropped, 0)
        hi = (ti + 1) * T // t - windows_dropped
        for ci in range(c):
            out.append((slice(lo, hi), slice(ci * N // c, (ci + 1) * N // c)))
    return out


def _wire_within_1lsb(a, b):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert d.max() <= 1, d.max()


def _assert_gathered(shards, gathered, mesh, replicated=()):
    """rank 0's gather equals the shards put together."""
    t, c = mesh
    for key, g in gathered.items():
        rows = []
        for ti in range(t):
            row = [shards[ti * c + ci][key] for ci in range(c)]
            rows.append(row[0] if key in replicated else np.concatenate(row, axis=1))
        np.testing.assert_array_equal(g, np.concatenate(rows, axis=0), err_msg=key)


# -- pure functions and refusals (no ranks) --------------------------------

@pytest.mark.parametrize("n_devices", range(1, 17))
def test_auto_mesh_shape_equals_jax(n_devices):
    for n_channels in (None, *range(1, 25)):
        assert auto_mesh_shape(n_devices, n_channels) == jax_auto_mesh_shape(n_devices,
                                                                              n_channels)


def test_auto_mesh_shape_cases():
    """tests/test_parallel.py:28-34."""
    assert auto_mesh_shape(8, 24) == (1, 8)
    assert auto_mesh_shape(8, 21) == (8, 1)
    assert auto_mesh_shape(4, 8) == (1, 4)
    t, c = auto_mesh_shape(8)
    assert t * c == 8


def test_make_mesh_raises_on_a_small_world():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="needs 4 ranks, have 1"):
        make_mesh(2, 2)


def test_refusals_before_any_rank():
    """The smoothing and backend refusals come before the mesh is read."""
    with pytest.raises(NotImplementedError):
        sharded.make_sharded_align(PipelineConfig(n_channels=4, block_len=L), None, "ema")
    with pytest.raises(ValueError):
        sharded.make_fused_time_sharded_align(PipelineConfig(n_channels=4, block_len=L), None)
    with pytest.raises(NotImplementedError):
        sharded.make_fused_time_sharded_align(
            PipelineConfig(n_channels=4, block_len=LF, **FUSED), None, smoothing="ema")


def test_parallel_imports_no_jax():
    """The port's parallel/ imports neither jax nor the JAX package."""
    for path in sorted((REPO / "coherent_rtlsdr_tpu_torch" / "parallel").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "coherent_rtlsdr_tpu"), (path, name)


# -- runners in gloo ranks ----------------------------------------------------

def test_sharded_align_2x2(tmp_path):
    """make_sharded_align on a (2, 2) mesh: T outputs, each rank's shard
    against the JAX sharded runner and the JAX unsharded engine, the truth
    on the last block; the 'ema' refusal."""
    mesh, N, T = (2, 2), 8, 8
    truth, sig, ref = _capture(N, T, seed=0, block_len=L)
    cfg = dict(n_channels=N, block_len=L)
    shards, gathered, refusals = _run_ranks(
        tmp_path, dict(runner="sharded_align", mesh=mesh, cfg=cfg), sig, ref)

    a_j, r_j, d_j, m_j = (np.asarray(x) for x in jax.block_until_ready(
        jpar.make_sharded_align(jpipe.PipelineConfig(**cfg), jpar.make_mesh(*mesh))(
            jnp.asarray(sig), jnp.asarray(ref))))
    res = jpipe.align_offline(jpipe.PipelineConfig(**cfg), jnp.asarray(sig), jnp.asarray(ref),
                              smoothing="global")
    for shard, (ts, cs) in zip(shards, _rank_slices(mesh, T, N)):
        np.testing.assert_allclose(shard["delay"], d_j[ts, cs], atol=1e-3)
        np.testing.assert_allclose(shard["mag"], m_j[ts, cs], atol=1e-5)
        np.testing.assert_allclose(shard["aligned"], a_j[ts, cs], atol=1e-3)
        np.testing.assert_allclose(shard["ref"], r_j[ts], atol=1e-5)
    _assert_gathered(shards, gathered, mesh, replicated=("ref",))
    np.testing.assert_allclose(gathered["delay"][1:], np.asarray(res.delay), atol=1e-3)
    np.testing.assert_allclose(gathered["aligned"][1:], np.asarray(res.aligned), atol=1e-3)
    np.testing.assert_allclose(gathered["delay"][-1], truth.delays, atol=0.05)
    assert all(r["ema"] == "NotImplementedError" for r in refusals)


@pytest.mark.parametrize("impl, mesh", [("fused", (1, 4)), ("xla", (1, 2))])
def test_channel_sharded_align(tmp_path, impl, mesh):
    """make_channel_sharded_align: every rank's (wire, delay, mag) against
    the JAX channel-sharded runner, and the refusal of a channel count the
    shards do not divide."""
    N = 8
    if impl == "fused":
        T = 4
        _, sig, ref = _capture(N, T, seed=3, block_len=LF, max_delay=20.0)
        sig, ref = sig.reshape(T, N, 2 * LF), ref.reshape(T, 2 * LF)
        cfg = dict(n_channels=N, block_len=LF, **FUSED)
    else:
        T = 4
        _, sig, ref = _capture(N, T, seed=0, block_len=L)
        cfg = dict(n_channels=N, block_len=L)
    shards, gathered, refusals = _run_ranks(
        tmp_path, dict(runner="channel", mesh=mesh, cfg=cfg), sig, ref)

    w_j, d_j, m_j = (np.asarray(x) for x in jpar.make_channel_sharded_align(
        jpipe.PipelineConfig(**cfg), jpar.make_mesh(*mesh))(jnp.asarray(sig), jnp.asarray(ref)))
    res = jpipe.align_offline(jpipe.PipelineConfig(**cfg), jnp.asarray(sig), jnp.asarray(ref),
                              smoothing="global")
    want_wire = np.asarray(res.wire if impl == "fused" else jax_c64_to_i8_iq(res.aligned))
    for shard, (_, cs) in zip(shards, _rank_slices(mesh, T - 1, N)):
        np.testing.assert_allclose(shard["delay"], d_j[:, cs], atol=1e-4)
        np.testing.assert_allclose(shard["mag"], m_j[:, cs], atol=1e-5)
        _wire_within_1lsb(shard["wire"], w_j[:, cs])
        _wire_within_1lsb(shard["wire"], want_wire[:, cs])
    _assert_gathered(shards, gathered, mesh)
    assert all(r["indivisible"] == "ValueError" for r in refusals)


@pytest.mark.parametrize("mesh, N, seed", [((2, 2), 8, 5), ((4, 1), 3, 6)],
                         ids=["time_and_channel", "time_only"])
def test_fused_time_sharded_align(tmp_path, mesh, N, seed):
    """make_fused_time_sharded_align: the raw-byte halo runner against the
    JAX one on the same mesh shape; window t >= 1 against the JAX unsharded
    engine's t - 1; the shard-boundary windows are real measurements (the
    truth on the last window); the wrong-backend and 'ema' refusals."""
    T = 8
    truth, sig, ref = _capture(N, T, seed=seed, block_len=LF, max_delay=20.0)
    sig, ref = sig.reshape(T, N, 2 * LF), ref.reshape(T, 2 * LF)
    cfg = dict(n_channels=N, block_len=LF, **FUSED)
    shards, gathered, refusals = _run_ranks(
        tmp_path, dict(runner="fused_time", mesh=mesh, cfg=cfg), sig, ref)

    w_j, wr_j, d_j, m_j = (np.asarray(x) for x in jax.block_until_ready(
        jpar.make_fused_time_sharded_align(jpipe.PipelineConfig(**cfg), jpar.make_mesh(*mesh))(
            jnp.asarray(sig), jnp.asarray(ref))))
    res = jpipe.align_offline(jpipe.PipelineConfig(**cfg), jnp.asarray(sig), jnp.asarray(ref),
                              smoothing="global")
    for shard, (ts, cs) in zip(shards, _rank_slices(mesh, T, N)):
        np.testing.assert_allclose(shard["delay"], d_j[ts, cs], atol=1e-4)
        np.testing.assert_allclose(shard["mag"], m_j[ts, cs], atol=1e-5)
        _wire_within_1lsb(shard["wire"], w_j[ts, cs])
        np.testing.assert_array_equal(shard["wire_ref"], wr_j[ts])
    _assert_gathered(shards, gathered, mesh, replicated=("wire_ref",))
    np.testing.assert_allclose(gathered["delay"][1:], np.asarray(res.delay), atol=1e-4)
    np.testing.assert_allclose(gathered["mag"][1:], np.asarray(res.mag), atol=1e-5)
    _wire_within_1lsb(gathered["wire"][1:], np.asarray(res.wire))
    np.testing.assert_array_equal(gathered["wire_ref"][1:], np.asarray(res.wire_ref))
    np.testing.assert_allclose(gathered["delay"][-1], truth.delays, atol=0.1)
    for r in refusals:
        assert r == {"backend": "ValueError", "ema": "NotImplementedError"}


@pytest.mark.parametrize("smoothing", ["global", "ema"])
def test_auto_sharded_align_2x2(tmp_path, smoothing):
    """make_auto_sharded_align (mxu, f32) on a (2, 2) mesh: the unsharded
    engine's T - 1 outputs for both smoothers, the EMA carried across the
    time shards; against the JAX auto-sharded runner."""
    mesh, N, T = (2, 2), 8, 8
    _, sig, ref = _capture(N, T, seed=4, block_len=LF)
    cfg = dict(n_channels=N, block_len=LF, fft_impl="mxu", mxu_precision="f32")
    shards, gathered, _ = _run_ranks(
        tmp_path, dict(runner="auto", mesh=mesh, cfg=cfg, smoothing=smoothing), sig, ref)

    rs = jpar.make_auto_sharded_align(jpipe.PipelineConfig(**cfg), jpar.make_mesh(*mesh),
                                      smoothing=smoothing)(jnp.asarray(sig), jnp.asarray(ref))
    ru = jpipe.align_offline(jpipe.PipelineConfig(**cfg), jnp.asarray(sig), jnp.asarray(ref),
                             smoothing=smoothing)
    for shard, (ts, cs) in zip(shards, _rank_slices(mesh, T, N, windows_dropped=1)):
        np.testing.assert_allclose(shard["delay"], np.asarray(rs.delay)[ts, cs], atol=1e-4)
        np.testing.assert_allclose(shard["mag"], np.asarray(rs.mag)[ts, cs], atol=1e-5)
        np.testing.assert_allclose(shard["aligned"], np.asarray(rs.aligned)[ts, cs], atol=1e-3)
    _assert_gathered(shards, gathered, mesh, replicated=("ref",))
    assert gathered["delay"].shape == (T - 1, N)
    np.testing.assert_allclose(gathered["delay"], np.asarray(ru.delay), atol=1e-4)
    np.testing.assert_allclose(gathered["aligned"], np.asarray(ru.aligned), atol=1e-3)
    np.testing.assert_allclose(gathered["ref"], np.asarray(ru.ref), atol=1e-5)


def test_auto_sharded_align_fused_ema_time_only(tmp_path):
    """make_auto_sharded_align with the fused backend and the EMA on a
    (2, 1) mesh: the gathered T - 1 outputs against the JAX unsharded fused
    engine (delay 1e-4, mag 1e-5, wire within 1 LSB, the reference bytes
    equal)."""
    mesh, N, T = (2, 1), 3, 8
    _, sig, ref = _capture(N, T, seed=8, block_len=LF, max_delay=20.0)
    sig, ref = sig.reshape(T, N, 2 * LF), ref.reshape(T, 2 * LF)
    cfg = dict(n_channels=N, block_len=LF, **FUSED)
    shards, gathered, _ = _run_ranks(
        tmp_path, dict(runner="auto", mesh=mesh, cfg=cfg, smoothing="ema"), sig, ref)
    ru = jpipe.align_offline(jpipe.PipelineConfig(**cfg), jnp.asarray(sig), jnp.asarray(ref),
                             smoothing="ema")
    _assert_gathered(shards, gathered, mesh, replicated=("ref", "wire_ref"))
    assert gathered["wire"].shape == (T - 1, N, 2 * LF)
    np.testing.assert_allclose(gathered["delay"], np.asarray(ru.delay), atol=1e-4)
    np.testing.assert_allclose(gathered["mag"], np.asarray(ru.mag), atol=1e-5)
    _wire_within_1lsb(gathered["wire"], np.asarray(ru.wire))
    np.testing.assert_array_equal(gathered["wire_ref"], np.asarray(ru.wire_ref))


def test_sharded_step_1x2(tmp_path):
    """make_sharded_step on a (1, 2) mesh over 4 blocks from shard_state of
    the initial state: the state and the aligned blocks against the JAX
    sharded step; the refusal of an indivisible channel count."""
    from jax.sharding import NamedSharding

    from coherent_rtlsdr_tpu.parallel.sharded import state_partition_spec

    mesh, N, T = (1, 2), 8, 4
    _, sig, ref = _capture(N, T, seed=1, block_len=L)
    cfg = dict(n_channels=N, block_len=L)
    shards, gathered, refusals = _run_ranks(
        tmp_path, dict(runner="step", mesh=mesh, cfg=cfg), sig, ref)

    jcfg = jpipe.PipelineConfig(**cfg)
    jmesh = jpar.make_mesh(*mesh)
    sfn = jpar.make_sharded_step(jcfg, jmesh, donate=False)
    state = jax.tree_util.tree_map(lambda x, s: jax.device_put(x, NamedSharding(jmesh, s)),
                                   jpipe.init_state(jcfg), state_partition_spec())
    aligned = []
    for t in range(T):
        state, out = sfn(state, jnp.asarray(sig[t]), jnp.asarray(ref[t]), jnp.array(True))
        aligned.append(np.asarray(out.aligned))
    aligned = np.stack(aligned, axis=1)   # [N, T, L]
    for shard, (_, cs) in zip(shards, _rank_slices(mesh, 1, N)):
        np.testing.assert_allclose(shard["delay"][0], np.asarray(state.delay)[cs], atol=1e-4)
        np.testing.assert_allclose(shard["phase"][0], np.asarray(state.phase)[cs], atol=1e-4)
        np.testing.assert_allclose(shard["aligned"][0], aligned[cs], atol=1e-3)
    _assert_gathered(shards, gathered, mesh)
    assert all(r["indivisible"] == "ValueError" for r in refusals)


# -- the app ------------------------------------------------------------------

def _jax_align_app(monkeypatch, tmp_path, argv):
    """The JAX package's apps/align_offline.py main() in this process."""
    import importlib.util

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(sys, "argv", ["align_offline.py", *argv])
    spec = importlib.util.spec_from_file_location("jax_align_offline_app",
                                                  REPO / "apps" / "align_offline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()


def test_align_offline_app_mesh2_matches_jax(tmp_path, monkeypatch):
    """``align_offline --cpu --mesh 2 --fft-impl fused`` (W = 4096), run as
    one command that starts its two gloo ranks itself, against the JAX app's ``--mesh 2
    --cpu`` npz on one capture: the same keys, shapes and dtypes, delay
    1e-4, mag 1e-5, wire within 1 LSB, the reference bytes equal."""
    N, T = 4, 8
    _, sig, ref = _capture(N, T, seed=6, block_len=LF)
    src = tmp_path / "capture.npz"
    seqnums = np.broadcast_to(np.arange(T, dtype=np.uint32)[:, None], (T, N + 1)).copy()
    save_capture(str(src), Capture(sig_u8=sig, ref_u8=ref, seqnums=seqnums, fs=2.048e6,
                                   fcenter=868e6))
    args = [str(src), "--fft-impl", "fused", "--mesh", "2", "--cpu"]
    out = subprocess.run([*NICE, *APP, *args, "-o", str(tmp_path / "port.npz")], cwd=REPO,
                         env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
                         text=True, timeout=RANK_TIMEOUT_S)
    assert out.returncode == 0, out.stdout + out.stderr
    _jax_align_app(monkeypatch, tmp_path, [*args, "-o", str(tmp_path / "jax.npz")])
    t, j = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(t.files) == sorted(j.files)
    for k in t.files:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    np.testing.assert_allclose(t["delay"], j["delay"], atol=1e-4)
    np.testing.assert_allclose(t["mag"], j["mag"], atol=1e-5)
    _wire_within_1lsb(t["aligned_i8"], j["aligned_i8"])
    np.testing.assert_array_equal(t["ref_i8"], j["ref_i8"])
    assert float(t["fs"]) == float(j["fs"]) == 2.048e6


def test_align_offline_app_mesh2_under_torchrun(tmp_path):
    """The same command under ``torchrun --standalone`` (torchrun's ranks,
    on a port it picks) writes the mesh npz, its arrays equal to the
    unsharded app's within the bars above."""
    N, T = 4, 6
    _, sig, ref = _capture(N, T, seed=7, block_len=L)
    src = tmp_path / "capture.npz"
    seqnums = np.broadcast_to(np.arange(T, dtype=np.uint32)[:, None], (T, N + 1)).copy()
    save_capture(str(src), Capture(sig_u8=sig, ref_u8=ref, seqnums=seqnums, fs=2.048e6,
                                   fcenter=868e6))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [*NICE, sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "coherent_rtlsdr_tpu_torch.apps.align_offline",
         str(src), "--mesh", "2", "--cpu", "-o", str(tmp_path / "mesh.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "over a 2-rank channel mesh" in out.stdout
    assert align_app.main([str(src), "--cpu", "-o", str(tmp_path / "one.npz")]) == 0
    t, o = np.load(tmp_path / "mesh.npz"), np.load(tmp_path / "one.npz")
    assert sorted(t.files) == ["aligned_i8", "delay", "fs", "mag", "ref_i8"]
    np.testing.assert_allclose(t["delay"], o["delay"], atol=1e-3)
    np.testing.assert_allclose(t["mag"], o["mag"], atol=1e-5)
    _wire_within_1lsb(t["aligned_i8"], o["aligned_i8"])
    np.testing.assert_array_equal(t["ref_i8"], o["ref_i8"])
