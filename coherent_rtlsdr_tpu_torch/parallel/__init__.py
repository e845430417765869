"""The (time, channel) mesh of ranks (port of
``coherent_rtlsdr_tpu/parallel/``).

The reference's concurrency is POSIX threads on one small ARM board
(SURVEY.md §2.4). Here the parallel axes are a ``(time, channel)`` mesh of
ranks of a ``torch.distributed`` process group, one a device:

  * ``channel``: embarrassingly parallel per-channel DSP; the reference
    channel is replicated to every shard (it is L complex samples).
  * ``time``: blocks of the capture; the only coupling is the overlap-save
    window straddling shard boundaries (one block of raw bytes exchanged
    point to point) and the smoother's small ``all_reduce``s.

The streaming server shards the channel axis of a (1, S) mesh: rank 0
runs the server loop and the other ranks follow it
(``make_sharded_server_runners``, ``serve_follower``).
"""

from coherent_rtlsdr_tpu_torch.parallel.mesh import auto_mesh_shape, make_mesh
from coherent_rtlsdr_tpu_torch.parallel.sharded import (
    make_auto_sharded_align,
    make_channel_sharded_align,
    make_fused_time_sharded_align,
    make_sharded_align,
    make_sharded_server_runners,
    make_sharded_step,
    serve_follower,
)

__all__ = [
    "make_mesh",
    "auto_mesh_shape",
    "make_auto_sharded_align",
    "make_channel_sharded_align",
    "make_fused_time_sharded_align",
    "make_sharded_align",
    "make_sharded_step",
    "make_sharded_server_runners",
    "serve_follower",
]
