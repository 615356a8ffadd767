"""The data-parallel mesh as a process group plus a device.

Counterpart of ``horovod_tpu/topology.py``: ``build_mesh`` (``:24``),
``data_axis`` (``:92``) and ``mesh_size`` (``:98``).  On the TPU a mesh
axis names the devices a ``psum`` spans; here one process drives one
device, so the axis is a ``torch.distributed`` process group and the mesh
also carries the device this process computes on.  ``exec_on_tpu`` has no
counterpart: a kernel wrapper chooses its route by the tensor's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """``group`` is the process group gradients are averaged over (None =
    the default world group); ``device`` is where this rank computes."""
    group: Optional[dist.ProcessGroup]
    device: torch.device

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def build_mesh(group: Optional[dist.ProcessGroup] = None,
               device=None) -> Mesh:
    """A mesh over ``group`` (default: every rank) on ``device`` (default:
    the device ``hvd.init`` chose)."""
    from horovod_tpu_torch import basics
    dev = torch.device(device) if device is not None else basics.device()
    return Mesh(group=group, device=dev)


def data_axis(mesh: Mesh) -> Optional[dist.ProcessGroup]:
    """The group gradients are averaged over (the GLOBAL communicator)."""
    return mesh.group


def mesh_size(mesh: Mesh) -> int:
    return mesh.size
