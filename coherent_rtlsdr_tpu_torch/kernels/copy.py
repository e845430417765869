"""The identity copy at the fused block geometry (port of the roofline
probe's Pallas copy, ``tools/probe_roofline.py:_copy_kernel``).

It measures the card, not the pipeline: the highest bandwidth a kernel that
reads and writes int8 blocks ``[T, N, m/2, 2m]`` reaches, one CTA per (t,
group of ``nc`` channels) as the Pallas grid had one step per (t, group).
A CPU tensor runs the plain version, ``copy_plain``; a CUDA tensor launches
the CUDA kernel (``csrc/probe_copy.cu``, bound in ``kernels/fused_cuda.py``)
or raises.
"""

import functools

import torch

# The launches of the CUDA kernel and the runs of the plain version.
COUNTS = ("copy_launches", "copy_plain_runs")


class BlockCopy:
    """Copies int8 blocks ``[T, N, m/2, 2m]`` and counts how."""

    def __init__(self):
        self.reset_counts()

    def reset_counts(self):
        """Zero the run counts: the kernel's, counted by its wrapper in
        ``fused_cuda`` right after it launches, and the plain version's."""
        for name in COUNTS:
            setattr(self, name, 0)

    def counts(self) -> dict:
        return {name: getattr(self, name) for name in COUNTS}

    def copy(self, x: torch.Tensor, nc: int = 1) -> torch.Tensor:
        """A new tensor equal to ``x``; on the card ``nc`` channels a CTA
        (N a multiple of nc), from a contiguous, 16-byte aligned ``x``."""
        if x.is_cuda:
            from coherent_rtlsdr_tpu_torch.kernels import fused_cuda

            return fused_cuda.copy_blocks(self, x, nc)
        if x.device.type == "cpu":
            return self.copy_plain(x)
        raise ValueError(f"no copy for device {x.device}")

    def copy_plain(self, x: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch version of :meth:`copy`, on the device of its input."""
        self.copy_plain_runs += 1
        return torch.empty_like(x).copy_(x)


@functools.lru_cache(maxsize=None)
def get_block_copy() -> BlockCopy:
    """The one :class:`BlockCopy` of the process, so its counts cover every
    caller."""
    return BlockCopy()
