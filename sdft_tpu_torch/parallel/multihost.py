"""Multi-process SPMD runtime helpers (counterpart of
``sdft_tpu.parallel.multihost``).

torch is multi-controller: one process per card, all running the same
program over one ``torch.distributed`` process group, with NCCL between
cards and Gloo on the CPU.  The sharded programs
(``sdft_tpu_torch.parallel.sharded``) are SPMD, so the same code runs on
one rank or on many.

Typical driver, one process per card (``torchrun --nproc-per-node N``):

    from sdft_tpu_torch.parallel import multihost, make_mesh, sharded_sdft
    multihost.initialize()                  # torchrun's environment
    mesh = make_mesh(time=N // 2, bins=2)
    state, dfts = sharded_sdft(plan, mesh, state, samples)
    multihost.shutdown()                    # drops the graphs, then the group

Sharded values are ``DTensor``s with the placements of ``STATE_SPECS``,
``SAMPLE_SPEC`` and ``DFT_SPEC``: ``host_local_to_global`` assembles one
from each rank's shard, ``global_array`` slices each rank's shard out of a
value every rank holds in full.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from .mesh import make_mesh


def _init_method(address: str | None) -> str | None:
    """'host:port' -> 'tcp://host:port'; a URL with a scheme passes as is."""
    if address is None or "://" in address:
        return address
    return f"tcp://{address}"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device_type: str = "cuda") -> None:
    """Initialize the default ``torch.distributed`` process group
    (idempotent: a group that exists is kept).

    With explicit arguments the group is made from them
    (``coordinator_address`` "host:port" or an init-method URL such as
    "file:///path"), and a failure raises.  Without them, the environment
    of ``torchrun`` (MASTER_ADDR, WORLD_SIZE, RANK) is read; outside any
    launcher a one-rank group is made in memory, so that a plain
    ``python`` run can use a 1x1x1 mesh.  The backend is NCCL for
    ``device_type="cuda"`` (each rank on card LOCAL_RANK) and Gloo for
    "cpu".
    """
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    rank = process_id
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device_type='cpu' for a "
                               "Gloo group on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if (coordinator_address, num_processes, process_id) != (None, None, None):
        dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                                world_size=num_processes, rank=process_id)
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)


def shutdown() -> None:
    """Destroy the default process group, after dropping every cached graph
    (``graphs.clear``): a graph that captured a rank's NCCL collectives
    (``parallel.sharded`` on a mesh of more than one rank) holds their
    communicator, and NCCL's destroy waits until no graph holds it, so
    ``torch.distributed.destroy_process_group`` alone would never return."""
    import gc

    from .. import graphs

    graphs.clear()
    gc.collect()
    dist.destroy_process_group()


def global_mesh(channel: int = 1, time: int = 1, bins: int = 1,
                device_type: str = "cuda") -> DeviceMesh:
    """Mesh over every rank of the process group."""
    n = channel * time * bins
    world = dist.get_world_size() if dist.is_initialized() else 0
    if n != world:
        raise ValueError(f"mesh {channel}x{time}x{bins}={n} must use all {world} "
                         f"ranks for multi-process SPMD")
    return make_mesh(channel, time, bins, device_type)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of the mesh: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def host_local_to_global(mesh: DeviceMesh, placements, local) -> DTensor:
    """Assemble a global DTensor from each rank's own shard (e.g. its part
    of a multi-channel sample stream): no rank holds the whole value.
    Shards must be even."""
    return DTensor.from_local(torch.as_tensor(local, device=mesh_device(mesh)), mesh,
                              placements, run_check=False)


def global_array(mesh: DeviceMesh, placements, value) -> DTensor:
    """A global DTensor from a value every rank holds in full (e.g. the
    carry State after a checkpoint restore): each rank slices its shard out
    of it, with no communication."""
    return distribute_tensor(torch.as_tensor(value, device=mesh_device(mesh)), mesh,
                             placements, src_data_rank=None)
