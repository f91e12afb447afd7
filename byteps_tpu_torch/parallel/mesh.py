"""Named mesh axes over the ``torch.distributed`` world.

Counterpart of ``byteps_tpu/parallel/mesh.py`` (``MeshSpec``,
``build_mesh``, ``set_global_mesh``, ``global_mesh``). One process drives
one device, so a JAX mesh of devices becomes a grid of ranks, and each
named axis becomes, on every process, the process group of the ranks that
share its other coordinates: the ``ici`` group is this process's row of
the ``(dcn, ici)`` grid, the ``dcn`` group its column. A sequence-parallel
axis (``"sp"``) is a mesh axis like any other.

Every process must build the same mesh, in the same order as the others:
``torch.distributed`` creates a group collectively, with every rank of the
world taking part (``dist.new_group``), so this works on a gloo world
whose processes share one card as well as on NCCL.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named description of the data-parallel mesh.

    ``dcn`` is the slow/outer axis (across hosts, the parameter-server leg
    in PS mode); ``ici`` is the fast/inner axis (inside a host). Either
    may be 1.
    """

    dcn: int
    ici: int
    dcn_axis: str = "dcn"
    ici_axis: str = "ici"

    @property
    def size(self) -> int:
        return self.dcn * self.ici


class Mesh:
    """A grid of ranks with named axes, row-major: rank ``r`` sits at the
    coordinates of ``r`` in ``shape`` (the last axis varies fastest), so
    ``Mesh((2, 4), ("dcn", "ici"))`` puts ranks 0-3 in the first ``ici``
    group. ``group(axis)`` is this process's group on that axis (None
    where the axis has one member), ``axis_size(axis)`` its length and
    ``index(axis)`` this process's coordinate on it."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")
        if math.prod(self.shape) != dist.get_world_size():
            raise ValueError(f"mesh {self.shape} != world size "
                             f"{dist.get_world_size()}")
        grid = list(itertools.product(*(range(n) for n in self.shape)))
        self._coords: Tuple[int, ...] = grid[dist.get_rank()]
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for a, name in enumerate(self.axis_names):
            # one group per line along axis a, made by every rank in order
            mine = self._coords[:a] + self._coords[a + 1:]
            for rest in sorted({c[:a] + c[a + 1:] for c in grid}):
                members = [grid.index(rest[:a] + (i,) + rest[a:])
                           for i in range(self.shape[a])]
                group = (dist.new_group(members) if self.shape[a] > 1
                         else None)
                if rest == mine:
                    self._groups[name] = group

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """This process's group on ``axis`` (None when the axis has one
        member)."""
        return self._groups[axis]

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        """This process's coordinate on ``axis``."""
        return self._coords[self.axis_names.index(axis)]


def build_mesh(spec: Optional[MeshSpec] = None, *,
               local_size: Optional[int] = None,
               dcn_axis: str = "dcn", ici_axis: str = "ici") -> Mesh:
    """A 2-D (dcn, ici) mesh over the world.

    Default layout: ``local_size`` processes (one host's devices) on the
    ici axis and one dcn group per host, like the JAX default of one dcn
    group per process with its local devices on ici. With no
    ``local_size`` the whole world is one host: dcn = 1, ici = world.
    """
    n = dist.get_world_size()
    if spec is None:
        local = local_size or n
        if n % local:
            raise ValueError(f"local_size {local} does not divide the "
                             f"world of {n}")
        spec = MeshSpec(dcn=n // local, ici=local, dcn_axis=dcn_axis,
                        ici_axis=ici_axis)
    if spec.size != n:
        raise ValueError(f"MeshSpec {spec.dcn}x{spec.ici} != world size {n}")
    return Mesh((spec.dcn, spec.ici), (spec.dcn_axis, spec.ici_axis))


_global_mesh: Optional[Mesh] = None


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    global _global_mesh
    _global_mesh = mesh


def global_mesh() -> Mesh:
    """The mesh installed by ``byteps_tpu_torch.init(mesh=...)``."""
    if _global_mesh is None:
        raise RuntimeError("byteps_tpu_torch mesh not initialised: call "
                           "byteps_tpu_torch.init(mesh=...) first")
    return _global_mesh
