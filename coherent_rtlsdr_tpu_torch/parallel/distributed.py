"""Process-group start-up and the global mesh (port of
``coherent_rtlsdr_tpu/parallel/distributed.py``).

One process a device: every rank calls ``init_multihost()`` once, before
any collective, then ``global_mesh``. The address, world size and rank come
from the arguments, from the JAX package's variables (COORDINATOR_ADDRESS /
NUM_PROCESSES / PROCESS_ID) or from torchrun's (MASTER_ADDR / WORLD_SIZE /
RANK); LOCAL_RANK and LOCAL_WORLD_SIZE, where set, place the rank on this
host's cards (otherwise the rank and the world stand in for them: one
host). The backend follows from the hardware: NCCL when each rank of this
host has a card of its own, gloo on the CPU and when ranks share a card.

``spawn_ranks`` is how an app run alone starts its own ranks.
"""

import os
import signal
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

# How long a collective may wait for another rank before it raises: the
# process group's and the sharded server's control group's. A rank that
# died closes its connections, which gloo reports at once; the timeout
# bounds a rank that hangs.
RANK_TIMEOUT = timedelta(minutes=10)


def _backend(device_type: str, local_rank: int, local_world: int) -> str:
    """The backend for ``device_type`` ranks, and this rank's card set."""
    if device_type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("init_multihost: no CUDA device for a 'cuda' rank; "
                           "pass device_type='cpu' to run the ranks on the CPU")
    n_cards = torch.cuda.device_count()
    torch.cuda.set_device(local_rank % n_cards)
    return "nccl" if local_world <= n_cards else "gloo"


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
    timeout: timedelta = RANK_TIMEOUT,
) -> None:
    """Start this rank's process group from the arguments or the
    environment; a no-op when none names a coordinator, and when a group
    exists already. ``coordinator_address`` is ``host:port`` (TCP) or a URL
    (``tcp://...``, ``file:///path``, which needs no port). ``device_type``
    is where the rank computes: "cuda" (the default; raises without a card)
    or "cpu". ``timeout`` bounds every collective of the group."""
    if dist.is_initialized():
        return
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is not None:
        init_method = addr if "://" in addr else f"tcp://{addr}"
        world = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
        rank = process_id if process_id is not None else int(os.environ.get("PROCESS_ID", "0"))
    elif "MASTER_ADDR" in os.environ:
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        return
    backend = _backend(device_type, int(os.environ.get("LOCAL_RANK", rank)),
                       int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)


def global_mesh(time: int, channel: int):
    """The (time, channel) mesh over every rank of every host (call after
    ``init_multihost``)."""
    from coherent_rtlsdr_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(time, channel)


def spawn_ranks(module: str, n_ranks: int, argv) -> int:
    """Run ``python -m module *argv`` in ``n_ranks`` child processes, ranks
    0 .. n-1 of one process group joined through a file store in a
    temporary directory. SIGINT and SIGTERM to this process go on to rank 0
    alone (a server's rank 0 then leaves its loop and releases the others).
    Returns the first failing rank's exit code (the others are stopped),
    else 0."""
    root = str(Path(__file__).resolve().parents[2])
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, COORDINATOR_ADDRESS=f"file://{tmp}/store",
                   NUM_PROCESSES=str(n_ranks), LOCAL_WORLD_SIZE=str(n_ranks),
                   PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n_ranks)))
        procs = [subprocess.Popen([sys.executable, "-m", module, *argv],
                                  env=dict(env, PROCESS_ID=str(r), LOCAL_RANK=str(r)))
                 for r in range(n_ranks)]
        relay = lambda signum, frame: procs[0].send_signal(signum)  # noqa: E731
        saved = {s: signal.signal(s, relay) for s in (signal.SIGINT, signal.SIGTERM)}
        running = list(procs)
        try:
            while running:
                for p in list(running):
                    rc = p.poll()
                    if rc is None:
                        continue
                    running.remove(p)
                    if rc:
                        return rc
                time.sleep(0.05)
            return 0
        finally:
            for s, handler in saved.items():
                signal.signal(s, handler)
            for p in running:
                p.kill()
                p.wait()
