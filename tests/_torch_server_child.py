"""One gloo rank of ``tests/test_torch_parallel_server.py`` (imports only
the port, numpy and torch).

    python tests/_torch_server_child.py DIR RANK WORLD

Reads ``DIR/spec.json`` and the global capture ``DIR/in.npz`` (``sig``,
``ref``, ``seqnums``), joins the process group through
``file://DIR/store`` and runs one case of the sharded server on a
``(1, WORLD)`` mesh: rank 0 the controller, the other ranks
``serve_follower``. Every rank writes ``DIR/out_<rank>.json`` (its runner
builds, blocks served, and what it measured) and ``DIR/out_<rank>.npz``
(its packed state's hist row 0, and on rank 0 the case's outputs).

Cases (``spec["case"]``):
  runners  ``make_sharded_server_runners`` from the initial state over the
           capture, one block a ``step`` call (``K`` = 1) or K a ``scan``
           call: the gathered wire, wire_ref, telemetry and final state.
  server   ``CoherentServer(mesh=...)`` on a ``FileSource`` of the capture
           (or the synthetic stream, ``spec["synth"]``) with an in-memory
           publisher: ``runs`` of ``[console commands, blocks]`` (the
           commands dispatched before the run), then the frames (those
           since the last change of the channel count), the
           state (and its seqnum columns after each run), the status line
           and the console replies.
  kill     the server runs 4 blocks, then rank 1 exits on its own
           (``DIR/die``); rank 0 records what its next run raises and
           how long it took.
"""

import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from coherent_rtlsdr_tpu_torch.io.server import CoherentServer  # noqa: E402
from coherent_rtlsdr_tpu_torch.io.streamio import Capture  # noqa: E402
from coherent_rtlsdr_tpu_torch.parallel.distributed import init_multihost  # noqa: E402
from coherent_rtlsdr_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from coherent_rtlsdr_tpu_torch.parallel.sharded import (  # noqa: E402
    make_sharded_server_runners,
    serve_follower,
)
from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig  # noqa: E402
from coherent_rtlsdr_tpu_torch.pipeline.state import state_to_numpy, unpack_state  # noqa: E402
from coherent_rtlsdr_tpu_torch.signal import make_truth  # noqa: E402
from coherent_rtlsdr_tpu_torch.signal.sources import (  # noqa: E402
    FileSource,
    SyntheticStreamSource,
)


class Publisher:
    def __init__(self):
        self.frames = []

    def publish(self, iq_i8, seqnums, phases=None):
        self.frames.append((np.array(iq_i8), np.array(seqnums), np.array(phases)))
        return iq_i8.size


class Control:
    def poll(self, handler, timeout_ms=0):
        return 0


def run_runners(spec, mesh, data):
    cfg = PipelineConfig(**spec["cfg"])
    K = spec["K"]
    r = make_sharded_server_runners(cfg, mesh, scan_depth=K, device="cpu")
    pstate = r.init_pstate()
    sig, ref = torch.from_numpy(data["sig"]), torch.from_numpy(data["ref"])
    seq = torch.from_numpy(data["seqnums"].astype(np.int64))
    wires, refs, telems = [], [], []
    for t in range(0, sig.shape[0], K):
        b = slice(t, t + K)
        if K == 1:
            pstate, w, wr, tel = r.step(pstate, sig[t], ref[t], True, seq[t])
            w, wr, tel = w[None], wr[None], tel[None]
        else:
            pstate, (w, wr), tel = r.scan(pstate, sig[b], ref[b], True, seq[b])
        wires.append(w)
        refs.append(wr)
        telems.append(tel)
    state = state_to_numpy(unpack_state(*r.get_state(pstate)))
    r.close()
    out = dict(wire=torch.cat(wires).numpy(), wire_ref=torch.cat(refs).numpy(),
               telem=torch.cat(telems).numpy(), hist0=pstate[2][0].numpy(),
               **{f"state_{k}": v for k, v in state.items()})
    return out, dict(n_runner_builds=r.n_runner_builds, blocks_served=r.blocks_served)


def make_server(spec, mesh, data, out_dir):
    cfg = PipelineConfig(**spec["cfg"])
    if spec.get("synth"):
        truth = make_truth(cfg.n_channels, seed=spec["synth"], max_delay=20.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=cfg.block_len, slab_blocks=8,
                                    seed=spec["synth"], device="cpu")
    else:
        src = FileSource(Capture(sig_u8=data["sig"], ref_u8=data["ref"],
                                 seqnums=data["seqnums"], fs=2.048e6, fcenter=868e6))
    state_path = os.path.join(out_dir, spec["state"]) if spec.get("state") else None
    return CoherentServer(cfg, src, publisher=Publisher(), control=Control(),
                          scan_depth=spec.get("scan_depth", 1),
                          max_channels=spec.get("max_channels"), state_path=state_path,
                          mesh=mesh, device="cpu")


def run_server(spec, mesh, data, out_dir):
    srv = make_server(spec, mesh, data, out_dir)
    published, replies, seqs_after = [], [], []
    for cmds, blocks in spec["runs"]:
        replies += [[cmd, srv.dispatcher.dispatch(cmd)] for cmd in cmds]
        published.append(srv.run(max_blocks=blocks))
        st = srv.state
        seqs_after.append(dict(last_seq=st.last_seq.tolist(), gaps=st.gaps.tolist()))
    st = srv.state
    frames = srv.publisher.frames
    shapes = sorted({f[0].shape for f in frames})
    out = {f"state_{f.name}": np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}
    # the frames since the last change of the channel count
    last = [f for f in frames if f[0].shape == frames[-1][0].shape]
    out.update(iq=np.stack([f[0] for f in last]), seqs=np.stack([f[1] for f in last]),
               phases=np.stack([f[2] for f in last]))
    out["hist0"] = srv._st[2][0].numpy()
    info = dict(published=published, seqs_after=seqs_after,
                status=srv.status().splitlines()[0],
                replies=replies, n_runner_builds=srv.n_runner_builds,
                n_active=srv.n_active, frame_shapes=[list(s) for s in shapes],
                last_frame_shape=list(frames[-1][0].shape), fs=srv.fs,
                blocks_served=srv._shards.blocks_served)
    srv.close()
    return out, info


def run_kill(spec, mesh, data, out_dir):
    srv = make_server(spec, mesh, data, out_dir)
    srv.run(max_blocks=4)
    open(os.path.join(out_dir, "die"), "w").close()
    t0 = time.monotonic()
    try:
        srv.run(max_blocks=10**6)
        raised = None
    except Exception as e:  # the test asserts the class
        raised = type(e).__name__
    return {}, dict(raised=raised, seconds=time.monotonic() - t0)


def die_on_signal(out_dir):
    """A follower of the kill case: exits (without a word to its peers) once
    rank 0 has written DIR/die."""
    while not os.path.exists(os.path.join(out_dir, "die")):
        time.sleep(0.01)
    os._exit(3)


def main():
    out_dir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    # One thread at a low priority: the test suite's other workers run
    # tests that keep pace with live sources on the same cores.
    os.nice(10)
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    data = dict(np.load(os.path.join(out_dir, "in.npz")))
    init_multihost(f"file://{os.path.join(out_dir, 'store')}", world, rank, device_type="cpu")
    try:
        mesh = make_mesh(1, world)
        if rank == 0:
            run = dict(runners=run_runners, server=run_server, kill=run_kill)[spec["case"]]
            args = (spec, mesh, data) + (() if spec["case"] == "runners" else (out_dir,))
            out, info = run(*args)
        else:
            if spec["case"] == "kill":
                threading.Thread(target=die_on_signal, args=(out_dir,), daemon=True).start()
            shard = serve_follower(mesh, "cpu")
            out = dict(hist0=shard.pstate[2][0].numpy())
            info = dict(n_runner_builds=shard.n_runner_builds,
                        blocks_served=shard.blocks_served)
        np.savez(os.path.join(out_dir, f"out_{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"out_{rank}.json"), "w") as f:
            json.dump(info, f)
    finally:
        if spec["case"] != "kill":
            torch.distributed.destroy_process_group()
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main()
