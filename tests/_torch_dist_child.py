"""One gloo rank of ``tests/test_torch_parallel.py`` (imports only the
port, numpy and torch).

    python tests/_torch_dist_child.py DIR RANK WORLD

Reads ``DIR/spec.json`` (the runner, the mesh, the config) and the global
capture ``DIR/in.npz``, joins the process group through ``file://DIR/store``,
runs the runner on this rank's shard, and writes ``DIR/out_<rank>.npz`` (its
output shard), ``DIR/refusals_<rank>.json`` (the exceptions the ``make_*`` runners
raised for inputs they refuse) and, on rank 0, ``DIR/gathered.npz`` (the
outputs put together by ``gather_to_rank0``).
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from coherent_rtlsdr_tpu_torch.parallel import sharded  # noqa: E402
from coherent_rtlsdr_tpu_torch.parallel.distributed import init_multihost  # noqa: E402
from coherent_rtlsdr_tpu_torch.parallel.mesh import (  # noqa: E402
    gather_to_rank0,
    local_shard,
    make_mesh,
)
from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig, init_state  # noqa: E402


def refused(build):
    try:
        build()
    except Exception as e:  # the test asserts the class name
        return type(e).__name__
    return None


def run_case(spec, mesh, sig, ref):
    """Returns ({name: (tensor, channel_dim)}, {refusal: exception name})."""
    cfg = PipelineConfig(**spec["cfg"])
    # A channel count the channel shards do not divide (none on one shard).
    bad = (PipelineConfig(**{**spec["cfg"], "n_channels": cfg.n_channels + 1})
           if spec["mesh"][1] > 1 else None)
    kind = spec["runner"]
    if kind == "sharded_align":
        run = sharded.make_sharded_align(cfg, mesh)
        a, r, d, m = run(local_shard(sig, mesh), local_shard(ref, mesh, channel_dim=None))
        return ({"aligned": (a, 1), "ref": (r, None), "delay": (d, 1), "mag": (m, 1)},
                {"ema": refused(lambda: sharded.make_sharded_align(cfg, mesh, "ema"))})
    if kind == "channel":
        run = sharded.make_channel_sharded_align(cfg, mesh)
        w, d, m = run(local_shard(sig, mesh, time_sharded=False), ref)
        return ({"wire": (w, 1), "delay": (d, 1), "mag": (m, 1)},
                {"indivisible": bad and refused(
                    lambda: sharded.make_channel_sharded_align(bad, mesh))})
    if kind == "fused_time":
        run = sharded.make_fused_time_sharded_align(cfg, mesh)
        w, wr, d, m = run(local_shard(sig, mesh), local_shard(ref, mesh, channel_dim=None))
        xla = PipelineConfig(**{**spec["cfg"], "fft_impl": "xla", "lag_method": "phase_slope"})
        return ({"wire": (w, 1), "wire_ref": (wr, None), "delay": (d, 1), "mag": (m, 1)},
                {"backend": refused(lambda: sharded.make_fused_time_sharded_align(xla, mesh)),
                 "ema": refused(lambda: sharded.make_fused_time_sharded_align(cfg, mesh,
                                                                              "ema"))})
    if kind == "auto":
        run = sharded.make_auto_sharded_align(cfg, mesh, spec["smoothing"])
        res = run(local_shard(sig, mesh), local_shard(ref, mesh, channel_dim=None))
        outs = {"delay": (res.delay, 1), "mag": (res.mag, 1), "lag": (res.lag, 1),
                "phase": (res.phase, 1), "aligned": (res.aligned, 1), "ref": (res.ref, None)}
        if res.wire is not None:
            outs.update(wire=(res.wire, 1), wire_ref=(res.wire_ref, None))
        return outs, {}
    if kind == "step":
        run = sharded.make_sharded_step(cfg, mesh)
        state = sharded.shard_state(init_state(cfg, "cpu"), mesh)
        sig_loc = local_shard(sig, mesh, time_sharded=False)
        outs = []
        for t in range(sig.shape[0]):
            state, out = run(state, sig_loc[t], ref[t], True)
            outs.append(out.aligned)
        # The state and the aligned blocks are replicated over time: one "block".
        return ({"delay": (state.delay[None], 1), "phase": (state.phase[None], 1),
                 "aligned": (torch.stack(outs, dim=1)[None], 1)},
                {"indivisible": bad and refused(lambda: sharded.make_sharded_step(bad, mesh))})
    raise ValueError(kind)


def main():
    out_dir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    # One thread at a low priority: the test suite's other workers run
    # tests that keep pace with live sources on the same cores.
    os.nice(10)
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    data = np.load(os.path.join(out_dir, "in.npz"))
    sig, ref = torch.from_numpy(data["sig"]), torch.from_numpy(data["ref"])
    init_multihost(f"file://{os.path.join(out_dir, 'store')}", world, rank, device_type="cpu")
    try:
        mesh = make_mesh(*spec["mesh"])
        outs, refusals = run_case(spec, mesh, sig, ref)
        np.savez(os.path.join(out_dir, f"out_{rank}.npz"),
                 **{k: v.numpy() for k, (v, _) in outs.items()})
        with open(os.path.join(out_dir, f"refusals_{rank}.json"), "w") as f:
            json.dump(refusals, f)
        gathered = {k: gather_to_rank0(v, mesh, channel_dim=cd) for k, (v, cd) in outs.items()}
        if rank == 0:
            np.savez(os.path.join(out_dir, "gathered.npz"),
                     **{k: v.numpy() for k, v in gathered.items()})
    finally:
        torch.distributed.destroy_process_group()
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main()
