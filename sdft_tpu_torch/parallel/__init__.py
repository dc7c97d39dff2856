"""Sharding over a ('channel', 'time', 'bins') mesh on torch.distributed
(counterpart of ``sdft_tpu.parallel``)."""

from . import multihost
from .mesh import AXES, make_mesh, single_device_mesh
from .sharded import (
    DFT_SPEC,
    SAMPLE_SPEC,
    STATE_SPECS,
    sharded_isdft,
    sharded_roundtrip,
    sharded_roundtrip_hopped,
    sharded_roundtrip_pallas,
    sharded_sdft,
    sharded_sdft_hopped,
    sharded_sdft_pallas,
    state_sharding,
)

__all__ = [
    "AXES",
    "multihost",
    "make_mesh",
    "single_device_mesh",
    "sharded_sdft",
    "sharded_sdft_pallas",
    "sharded_sdft_hopped",
    "sharded_isdft",
    "sharded_roundtrip",
    "sharded_roundtrip_hopped",
    "sharded_roundtrip_pallas",
    "state_sharding",
    "STATE_SPECS",
    "SAMPLE_SPEC",
    "DFT_SPEC",
]
