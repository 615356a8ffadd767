"""Meshes: named axes as process groups, plus a device.

Counterpart of ``horovod_tpu/topology.py``: ``build_mesh`` (``:24``, with
the ``("dcn", "ici")`` shape derived from the topology),
``data_axis`` (``:92``) and ``mesh_size`` (``:98``).  On the TPU a mesh
axis names the devices a ``psum`` spans; here one process drives one
device, so an axis is a ``torch.distributed`` process group and the mesh
also carries the device this process computes on.  ``exec_on_tpu`` has no
counterpart: a kernel wrapper chooses its route by the tensor's device.

A mesh with several axes (``build_mesh(axes=("data", "model", "seq"),
shape=(2, 2, 2))``) lays the ranks out as JAX lays devices out in
``Mesh(devices.reshape(shape), axes)``: rank r takes the row-major
coordinates of r in ``shape``.  Along each axis, the ranks that share
every other coordinate form one group, ordered by that axis's
coordinate, so a rank's position in its ``seq`` group is its sequence
shard (shard i owns global positions ``[i*T, (i+1)*T)``).  Every set of
axes gets its group too (``mesh.axis(("data", "seq"))``, the gradient
mean of the LM's step).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AxisNames = Union[str, Sequence[str]]


@dataclass(frozen=True, eq=False)
class Mesh:
    """``group`` is the process group gradients are averaged over (None =
    the default world group); ``device`` is where this rank computes.
    ``axes``/``shape``/``coords`` name the grid and this rank's place in
    it; ``groups`` maps each set of axes (in mesh order) to this rank's
    group over them."""
    group: Optional[dist.ProcessGroup]
    device: torch.device
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[Tuple[str, ...], Optional[dist.ProcessGroup]]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def _key(self, names: AxisNames) -> Tuple[str, ...]:
        names = (names,) if isinstance(names, str) else tuple(names)
        unknown = [a for a in names if a not in self.axes]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh's axes "
                             f"{self.axes}")
        return tuple(a for a in self.axes if a in names)

    def axis(self, names: AxisNames) -> Optional[dist.ProcessGroup]:
        """This rank's group over one axis or a set of axes."""
        return self.groups[self._key(names)]

    def axis_size(self, names: AxisNames) -> int:
        return math.prod(self.shape[self.axes.index(a)]
                         for a in self._key(names))

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name``."""
        return self.coords[self.axes.index(self._key(name)[0])]


def _coords(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _grid_groups(axes: Tuple[str, ...], shape: Tuple[int, ...], rank: int):
    """One group per slice of the grid for every non-empty set of axes.
    Creating a group is collective over the whole world, so every rank
    creates every slice's group, in the same order."""
    world = math.prod(shape)
    coords = [_coords(r, shape) for r in range(world)]
    groups = {}
    for n in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), n):
            others = [i for i in range(len(axes)) if i not in sub]
            mine = None
            for fixed in itertools.product(*(range(shape[i])
                                             for i in others)):
                members = [r for r in range(world)
                           if all(coords[r][i] == f
                                  for i, f in zip(others, fixed))]
                group = dist.new_group(members)
                if rank in members:
                    mine = group
            groups[tuple(axes[i] for i in sub)] = mine
    return groups


def build_mesh(group: Optional[dist.ProcessGroup] = None, device=None, *,
               axes: Optional[Sequence[str]] = None,
               shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh on ``device`` (default: the device ``hvd.init`` chose).

    Without ``axes``: one data axis over ``group`` (default: every rank).
    With ``axes`` and ``shape``: the grid over every rank of the world
    (``prod(shape)`` must be the world size), one group per slice of each
    axis and of each set of axes (``axes=("dcn", "ici")`` without a shape
    takes hosts x ranks per host from ``hvd.topology()``, reference
    ``:36-53``); ``group`` is then the data axis's
    (``"data"`` if the mesh has it, else the last axis, as the reference's
    ``data_axis``).  Call it on the main thread of every rank in the same
    order as any other group creation (``hvd.add_process_set``): creating
    a group is collective over the world.
    """
    from horovod_tpu_torch import basics
    dev = torch.device(device) if device is not None else basics.device()
    if axes is None:
        if shape is not None:
            raise ValueError("shape needs axes")
        return Mesh(group=group, device=dev, axes=("data",),
                    shape=(dist.get_world_size(group),),
                    coords=(dist.get_rank(group),),
                    groups={("data",): group})
    axes = tuple(axes)
    if shape is None:
        n = dist.get_world_size()
        if axes == ("dcn", "ici"):
            # The two-level shape from the topology: dcn = hosts, ici =
            # ranks per host; one host degenerates to (1, n).
            topo = basics.topology()
            dcn = max(topo.num_hosts, 1)
            if n % dcn != 0:
                raise ValueError(
                    f"cannot derive ('dcn', 'ici') mesh shape: {n} ranks "
                    f"do not divide evenly over {dcn} hosts "
                    f"({topo.hosts}); pass shape= explicitly")
            shape = (dcn, n // dcn)
        elif len(axes) != 1:
            raise ValueError(f"shape required for multi-axis mesh {axes}")
        else:
            shape = (n,)
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes} and shape {shape} must pair "
                         f"one distinct name with each size")
    if group is not None or basics.process_group() is not None:
        raise ValueError("a mesh with named axes spans the whole world; "
                         "a job restricted by init(ranks=...) has none")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh shape {shape} does not cover the "
                         f"{dist.get_world_size()} ranks of the world")
    rank = dist.get_rank()
    groups = _grid_groups(axes, shape, rank)
    name = "data" if "data" in axes else axes[-1]
    return Mesh(group=groups[(name,)], device=dev, axes=axes, shape=shape,
                coords=_coords(rank, shape), groups=groups)


def data_axis(mesh: Mesh) -> Optional[dist.ProcessGroup]:
    """The group gradients are averaged over (the GLOBAL communicator)."""
    return mesh.group


def mesh_size(mesh: Mesh) -> int:
    return mesh.size
