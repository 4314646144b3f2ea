"""The device mesh of the sharded engines.

In the JAX package a mesh is a 1-D ``jax.sharding.Mesh`` whose one axis
(``AXIS``) holds the row shards; the query is replicated and the merge is
an ``all_gather`` of each shard's candidates. In the port a mesh is a 1-D
list of ``torch.device``s, one row shard per entry (its position), in
order. An entry may repeat: ``[torch.device("cpu")] * 4`` runs four
shards on the CPU, ``[torch.device("cuda", 0)] * 4`` four on one card.
``owners[i]`` names the rank of the process that holds position i (all
0 in one process; ``distributed.global_mesh`` builds the mesh of several
processes).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

AXIS = "shards"


class Mesh(list):
    """A 1-D list of torch.devices along ``AXIS``, with the rank owning
    each position (``owners``)."""

    axis = AXIS

    def __init__(self, devices: Sequence, owners: Optional[Sequence] = None):
        super().__init__(torch.device(d) for d in devices)
        if not self:
            raise ValueError("a mesh needs at least one device")
        self.owners = ([0] * len(self) if owners is None
                       else [int(r) for r in owners])
        if len(self.owners) != len(self):
            raise ValueError(f"{len(self.owners)} owners for {len(self)} "
                             "devices")


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over ``devices`` (torch.device or strings), or, with none
    given, over every visible CUDA device. Raises where there is none:
    pass the devices, e.g. ``[torch.device("cpu")] * 4``, to shard on the
    CPU."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device is visible: pass devices= "
                               "(e.g. [torch.device('cpu')] * 4)")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(list(devices))
