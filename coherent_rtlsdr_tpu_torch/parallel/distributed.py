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
"""

import os
from typing import Optional

import torch
import torch.distributed as dist


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
) -> None:
    """Start this rank's process group from the arguments or the
    environment; a no-op when none names a coordinator, and when a group
    exists already. ``coordinator_address`` is ``host:port`` (TCP) or a URL
    (``tcp://...``, ``file:///path``, which needs no port). ``device_type``
    is where the rank computes: "cuda" (the default; raises without a card)
    or "cpu"."""
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
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def global_mesh(time: int, channel: int):
    """The (time, channel) mesh over every rank of every host (call after
    ``init_multihost``)."""
    from coherent_rtlsdr_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(time, channel)
