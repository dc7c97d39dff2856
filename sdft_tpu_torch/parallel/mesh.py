"""Device mesh construction for the SDFT workload (counterpart of
``sdft_tpu.parallel.mesh``).

Three parallel axes:

  * ``channel`` — data parallelism over independent audio channels;
  * ``time``    — sequence parallelism over contiguous sample blocks; the
    carry is the m-complex accumulator total, combined with an exclusive
    prefix across ranks;
  * ``bins``    — "tensor" parallelism over DFT bins; the window
    convolution exchanges a 1-2 bin halo with the neighbour shards.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dimensions
are named ``AXES``; ``mesh.get_group("time")`` and the like are the axis
groups.  torch is multi-controller: every rank runs the same program, and
the mesh spans every rank of the initialized process group
(``parallel.multihost.initialize``, or ``torchrun``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("channel", "time", "bins")


def make_mesh(channel: int = 1, time: int = 1, bins: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A (channel, time, bins) mesh over the ranks of the process group, on
    the card (one per rank) unless ``device_type="cpu"`` is asked for.
    Raises without an initialized process group, without a card for
    "cuda", and when channel*time*bins is not the group's size."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group: call "
                           "sdft_tpu_torch.parallel.multihost.initialize() "
                           "(or run under torchrun) first")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for a 'cuda' mesh: pass "
                           "device_type='cpu' to shard on the CPU")
    n = channel * time * bins
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {channel}x{time}x{bins} needs {n} ranks, the "
                         f"process group has {world}")
    return init_device_mesh(device_type, (channel, time, bins), mesh_dim_names=AXES)


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The 1x1x1 mesh of a one-rank process group."""
    return make_mesh(1, 1, 1, device_type)
