"""The ranks' layout: process groups in place of mesh axes.

Counterpart of ``hydragnn_tpu/parallel/mesh.py``. The JAX package names
the axes of a ``jax.sharding.Mesh`` (``data``, and ``fsdp`` for
parameter sharding) and stacks a step's sub-batches along ``data``
(``stack_batches``/``shard_stacked_batch``). The port's ranks stand in
for the mesh's devices in its row-major order: rank ``r`` sits at
``(r // fsdp, r % fsdp)`` of the ``data x fsdp`` grid. A step has
``data`` slots; the ``fsdp`` ranks of one row share a slot (their
sub-batch is the same, as the JAX package shards the batch over
``data`` only) and shard the parameters. So "this rank's slot of the
step" replaces stacking, and two kinds of group carry the collectives:

- the slot group: one rank per slot (a column of the grid), over which
  counts, losses and the dp gradient are summed;
- the parameter-sharding device mesh of FSDP2 (``parallel/dp``): the
  whole world for ZeRO (``fsdp_axis "data"``), the ``(replicate,
  shard)`` grid for HSDP (``fsdp > 1``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch.distributed as dist


@dataclass
class DataMesh:
    """``data`` slots x ``fsdp`` ranks a slot. Groups are made on first
    use, by every rank together (``dist.new_group`` and
    ``init_device_mesh`` are collective)."""

    data: int
    fsdp: int = 1
    _groups: Dict[str, object] = field(default_factory=dict, repr=False, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "fsdp": self.fsdp}

    @property
    def size(self) -> int:
        return self.data * self.fsdp

    def slot_of(self, rank: int) -> int:
        """The step slot (the ``data`` index) of ``rank``."""
        return int(rank) // self.fsdp

    def slot(self) -> int:
        return self.slot_of(dist.get_rank() if dist.is_initialized() else 0)

    def active(self) -> bool:
        """Whether there is a group to reduce over (a world of one without
        a process group reduces over nothing)."""
        return dist.is_initialized()

    def slot_group(self):
        """The group holding one rank per slot (this rank's column); None
        is the default group (``fsdp == 1``)."""
        if self.fsdp == 1 or not self.active():
            return None
        if "slot" not in self._groups:
            mine = None
            for j in range(self.fsdp):
                g = dist.new_group([i * self.fsdp + j for i in range(self.data)])
                if dist.get_rank() % self.fsdp == j:
                    mine = g
            self._groups["slot"] = mine
        return self._groups["slot"]

    def device_mesh(self, device_type: str):
        """FSDP2's device mesh: 1-D over every rank (ZeRO, ``fsdp == 1``)
        or ``(replicate, shard)`` = ``(data, fsdp)`` (HSDP)."""
        if "device_mesh" not in self._groups:
            from torch.distributed.device_mesh import init_device_mesh

            if self.fsdp == 1:
                dm = init_device_mesh(device_type, (self.data,))
            else:
                dm = init_device_mesh(device_type, (self.data, self.fsdp),
                                      mesh_dim_names=("replicate", "shard"))
            self._groups["device_mesh"] = dm
        return self._groups["device_mesh"]


def make_mesh(axes: Optional[Dict[str, int]] = None) -> DataMesh:
    """A ``DataMesh`` from ``{"data": a, "fsdp": k}`` (default: every
    rank on ``data``)."""
    if axes is None:
        axes = {"data": dist.get_world_size() if dist.is_initialized() else 1}
    unknown = set(axes) - {"data", "fsdp"}
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)} are not data/fsdp")
    return DataMesh(data=int(axes["data"]), fsdp=int(axes.get("fsdp", 1)))
