"""Production meshes (torch port of ``repro.launch.mesh``).

A 256- or 512-chip mesh cannot be built from the cards of one machine, so
``make_production_mesh`` and ``make_mesh_from_spec`` return an abstract
mesh: its axis names, their sizes in order and the device count, nothing
more. It makes no device and no process group, and importing this module
starts nothing. ``dist.sharding`` reads only those fields, so the layout
rules and spec trees of a production mesh are computed without devices,
as the reference computes them against an abstract mesh.

``device_mesh`` realises an abstract mesh over the current process group
as a ``torch.distributed.device_mesh.DeviceMesh`` with the same dim names,
once the world size equals the mesh's size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a device mesh, with no devices."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(
                f"{len(self.axis_names)} axis names for "
                f"{len(self.axis_sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in the mesh's order."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 single pod (256 chips) or 2x16x16 (2 pods, 512 chips)."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_mesh_from_spec(shape: Sequence[int],
                        axes: Sequence[str]) -> AbstractMesh:
    """Arbitrary mesh for scale-out (e.g. (8, 32, 16) = 4096 chips)."""
    return AbstractMesh(tuple(axes), tuple(int(s) for s in shape))


def device_mesh(mesh: AbstractMesh, device_type: str = "cuda"):
    """``mesh`` realised over the current process group: a ``DeviceMesh``
    of ``device_type`` with the same dim names and sizes (rank r at the
    row-major position r). Raises when the world size is not
    ``mesh.size``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != mesh.size:
        raise ValueError(
            f"mesh {mesh.shape} needs {mesh.size} ranks, the process group "
            f"has {world}")
    return init_device_mesh(device_type, mesh.axis_sizes,
                            mesh_dim_names=mesh.axis_names)
