"""The (time, channel) mesh (port of ``coherent_rtlsdr_tpu/parallel/mesh.py``)
and the helpers a rank needs around it.

The JAX package runs one controller over a device mesh. The port runs one
process per device, a rank of a ``torch.distributed`` process group: the
mesh is a ``DeviceMesh`` over ranks ``0 .. time * channel - 1``, time-major,
so rank r sits at ``(r // channel, r % channel)``. Every rank calls a runner
with its own shard (``local_shard``), as ``shard_map``'s local function
sees it, and ``gather_to_rank0`` puts the shards of an output back together.

Collectives take the device of their group: a rank's CUDA tensors on NCCL,
host copies on gloo (the CPU, or ranks that share a card).
"""

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

TIME_AXIS = "time"
CHANNEL_AXIS = "channel"


def auto_mesh_shape(n_devices: int, n_channels: Optional[int] = None) -> Tuple[int, int]:
    """Choose a (time, channel) factorization of ``n_devices``.

    Prefer the largest channel-axis factor that divides both the device count
    and (if given) the channel count — channel parallelism is collective-free,
    so it should soak up as many devices as the channel count supports; the
    rest go to the time axis.
    """
    best_c = 1
    for c in range(1, n_devices + 1):
        if n_devices % c:
            continue
        if n_channels is not None and n_channels % c:
            continue
        best_c = c
    return n_devices // best_c, best_c


def make_mesh(time: int, channel: int) -> DeviceMesh:
    """The (time, channel) mesh over the first ``time * channel`` ranks of
    the process group (``distributed.init_multihost``). Its device type is
    that of the group's collectives: "cuda" on NCCL, "cpu" on gloo."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < time * channel:
        raise ValueError(f"mesh {time}x{channel} needs {time * channel} ranks, have {world}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_multihost first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(time * channel).view(time, channel),
                      mesh_dim_names=(TIME_AXIS, CHANNEL_AXIS))


def mesh_shape(mesh: DeviceMesh) -> Tuple[int, int]:
    """(time, channel) sizes of ``mesh``."""
    return mesh.size(0), mesh.size(1)


def mesh_coords(mesh: DeviceMesh) -> Tuple[int, int]:
    """This rank's (time_index, channel_index) on ``mesh``."""
    return mesh.get_local_rank(TIME_AXIS), mesh.get_local_rank(CHANNEL_AXIS)


def _part(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{n} {what} not divisible by {parts} shards")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def block_slice(mesh: DeviceMesh, n_blocks: int) -> slice:
    """This rank's blocks of a global ``[T, ...]`` array (time axis)."""
    return _part(n_blocks, mesh_shape(mesh)[0], mesh_coords(mesh)[0], "blocks")


def channel_slice(mesh: DeviceMesh, n_channels: int) -> slice:
    """This rank's channels of ``n_channels`` (channel axis)."""
    return _part(n_channels, mesh_shape(mesh)[1], mesh_coords(mesh)[1], "channels")


def local_shard(x: torch.Tensor, mesh: DeviceMesh, channel_dim: Optional[int] = 1,
                time_sharded: bool = True) -> torch.Tensor:
    """This rank's shard of a global array: blocks on dim 0 split over the
    time axis (unless ``time_sharded`` is false: replicated over it) and
    channels on ``channel_dim`` over the channel axis (``None``: replicated,
    as the reference channel is)."""
    if time_sharded:
        x = x[block_slice(mesh, x.shape[0])]
    if channel_dim is not None:
        sl = channel_slice(mesh, x.shape[channel_dim])
        x = x.narrow(channel_dim, sl.start, sl.stop - sl.start)
    return x


def comm_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as a collective on ``group`` takes it: on its own device for
    NCCL, on the host for gloo (which takes no CUDA tensor for most
    operations); complex as (re, im) float pairs, bool as uint8."""
    if x.is_complex():
        x = torch.view_as_real(x)
    elif x.dtype == torch.bool:
        x = x.to(torch.uint8)
    x = x.contiguous()
    return x if dist.get_backend(group) == "nccl" else x.cpu()


def from_comm_tensor(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`comm_tensor` onto ``like``'s device and dtype."""
    buf = buf.to(like.device)
    if like.is_complex():
        return torch.view_as_complex(buf.contiguous())
    return buf.to(like.dtype)


def gather_to_rank0(x: torch.Tensor, mesh: DeviceMesh,
                    channel_dim: Optional[int] = 1) -> Optional[torch.Tensor]:
    """Every rank's shard ``x`` (blocks on dim 0, channels on
    ``channel_dim``, or ``None`` for an output replicated over the channel
    axis) put back into the global array on rank 0, on ``x``'s device; the
    other ranks get ``None``. Every rank of the mesh calls it, and the mesh
    covers the whole group. Shards may differ in length on dim 0
    (``make_auto_sharded_align``'s time shard 0)."""
    t, c = mesh_shape(mesh)
    if dist.get_world_size() != t * c:
        raise ValueError(f"gather_to_rank0 needs the mesh to cover the group: {t}x{c} "
                         f"mesh, {dist.get_world_size()} ranks")
    buf = comm_tensor(x, None)
    lens = [torch.zeros(1, dtype=torch.int64, device=buf.device) for _ in range(t * c)]
    dist.all_gather(lens, torch.tensor([buf.shape[0]], device=buf.device))
    lens = [int(n) for n in lens]
    pad = max(lens)
    if buf.shape[0] < pad:
        buf = torch.cat([buf, buf.new_zeros((pad - buf.shape[0], *buf.shape[1:]))])
    parts = [torch.empty_like(buf) for _ in range(t * c)]
    dist.all_gather(parts, buf)
    if dist.get_rank() != 0:
        return None
    parts = [from_comm_tensor(p[:n], x) for p, n in zip(parts, lens)]
    rows = [parts[ti * c: (ti + 1) * c] for ti in range(t)]
    rows = [row[0] if channel_dim is None else torch.cat(row, dim=channel_dim) for row in rows]
    return torch.cat(rows, dim=0)
