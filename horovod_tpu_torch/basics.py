"""Process and topology state: the ``hvd.init()`` surface over
``torch.distributed``.

Counterpart of ``horovod_tpu/basics.py``.  One process drives one device,
as in the reference Horovod.  ``init`` always creates a process group, at
size 1 too, so the gradient all-reduce of a single-card run goes through
the same collective library as a multi-card one: NCCL when the device is
a GPU, gloo when the caller asked for the CPU.

Rank and size come from the launcher's ``HOROVOD_RANK``/``HOROVOD_SIZE``
contract.  The rendezvous address comes from ``HOROVOD_COORDINATOR_ADDR``
(``host:port``), else from torch's own ``MASTER_ADDR``/``MASTER_PORT``;
only a size-1 world may fall back to a free localhost port.
"""

from __future__ import annotations

import atexit
import os
import socket
import threading
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import config

NOT_INITIALIZED_ERROR = (
    "horovod_tpu_torch has not been initialized; use hvd.init()."
)


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.initialized = False
        self.rank, self.size = 0, 1
        self.local_rank, self.local_size = 0, 1
        self.cross_rank, self.cross_size = 0, 1
        self.device: Optional[torch.device] = None


_state = _State()


def _free_localhost_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def resolve_device(device=None, local_rank: Optional[int] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` when the caller names
    one, else ``cuda:<local_rank>``.  Raises when no GPU is present and
    the caller did not ask for the CPU: nothing falls back quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch runs on a CUDA device and none is present; "
            "pass device='cpu' to run on the CPU")
    if local_rank is None:
        local_rank = (_state.local_rank if _state.initialized
                      else config.env_int("HOROVOD_LOCAL_RANK", 0) or 0)
    return torch.device("cuda", local_rank)


def _init_method(size: int) -> str:
    coord = config.env_raw("HOROVOD_COORDINATOR_ADDR")
    if coord:
        return f"tcp://{coord}"
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return "env://"
    if size == 1:
        return f"tcp://127.0.0.1:{_free_localhost_port()}"
    raise RuntimeError(
        f"a world of size {size} needs a rendezvous address: set "
        f"HOROVOD_COORDINATOR_ADDR=host:port or MASTER_ADDR/MASTER_PORT")


def init(device=None) -> None:
    """Initialize horovod_tpu_torch (reference ``basics.py:90``).

    ``device`` defaults to ``cuda:<local_rank>``; pass ``"cpu"`` to run on
    the CPU over gloo.  Topology resolution follows the JAX package: the
    ``HOROVOD_*`` env contract, with local = global and one host when the
    launcher exported nothing.
    """
    with _state.lock:
        if _state.initialized:
            return
        rank = config.env_int("HOROVOD_RANK", 0)
        size = config.env_int("HOROVOD_SIZE", 1)
        local_rank = config.env_int("HOROVOD_LOCAL_RANK", rank)
        local_size = config.env_int("HOROVOD_LOCAL_SIZE", size)
        cross_rank = config.env_int("HOROVOD_CROSS_RANK",
                                    rank // max(local_size, 1))
        cross_size = config.env_int("HOROVOD_CROSS_SIZE",
                                    -(-size // max(local_size, 1)))
        dev = resolve_device(device, local_rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=_init_method(size),
                                rank=rank, world_size=size)
        _state.rank, _state.size = rank, size
        _state.local_rank, _state.local_size = local_rank, local_size
        _state.cross_rank, _state.cross_size = cross_rank, cross_size
        _state.device = dev
        _state.initialized = True


def shutdown() -> None:
    """Tear down the process group ``init`` created (reference
    ``basics.py:211``)."""
    with _state.lock:
        if not _state.initialized:
            return
        if dist.is_initialized():
            dist.destroy_process_group()
        _state.reset()


atexit.register(shutdown)


def is_initialized() -> bool:
    return _state.initialized


def _check_initialized() -> None:
    if not _state.initialized:
        raise ValueError(NOT_INITIALIZED_ERROR)


def rank() -> int:
    _check_initialized()
    return _state.rank


def size() -> int:
    _check_initialized()
    return _state.size


def local_rank() -> int:
    _check_initialized()
    return _state.local_rank


def local_size() -> int:
    _check_initialized()
    return _state.local_size


def cross_rank() -> int:
    _check_initialized()
    return _state.cross_rank


def cross_size() -> int:
    _check_initialized()
    return _state.cross_size


def device() -> torch.device:
    """The device this process drives."""
    _check_initialized()
    return _state.device


class Topology(NamedTuple):
    """The job's host->slots map plus this rank's place in it
    (reference ``basics.py:289``).  ``leaders`` holds the global rank of
    each host's slot 0; ``local_group`` the global ranks on this host."""
    hosts: Tuple[Tuple[str, int], ...]
    hostname: str
    leaders: Tuple[int, ...]
    local_group: Tuple[int, ...]
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int

    @property
    def num_hosts(self) -> int:
        return len(self.hosts)

    @property
    def leader(self) -> int:
        return self.local_group[0] if self.local_group else self.rank

    @property
    def is_leader(self) -> bool:
        return self.local_rank == 0


def _build_topology(rank: int, size: int, local_rank: int, local_size: int,
                    cross_rank: int, cross_size: int) -> Topology:
    """Uniform block synthesis from the LOCAL/CROSS contract: cross_size
    hosts of local_size slots (rank = host * local_size + local_rank), the
    last host taking the remainder of a world that does not divide."""
    hosts = []
    for h in range(max(cross_size, 1)):
        slots = (min(local_size, size - h * local_size) if local_size > 0
                 else size)
        if slots <= 0:
            break
        hosts.append(("", slots))
    leaders, base = [], 0
    host_start, host_slots = 0, size
    for _, slots in hosts:
        leaders.append(base)
        if base <= rank < base + slots:
            host_start, host_slots = base, slots
        base += slots
    return Topology(
        hosts=tuple(hosts), hostname="", leaders=tuple(leaders),
        local_group=tuple(range(host_start, host_start + host_slots)),
        rank=rank, size=size, local_rank=local_rank, local_size=local_size,
        cross_rank=cross_rank, cross_size=cross_size)


def topology() -> Topology:
    """The job topology (reference ``basics.py:381``)."""
    _check_initialized()
    return _build_topology(_state.rank, _state.size, _state.local_rank,
                           _state.local_size, _state.cross_rank,
                           _state.cross_size)


def mesh():
    """The data-parallel mesh over every rank: the default process group
    and this process's device (see :mod:`horovod_tpu_torch.topology`)."""
    from horovod_tpu_torch.topology import build_mesh
    _check_initialized()
    return build_mesh()
