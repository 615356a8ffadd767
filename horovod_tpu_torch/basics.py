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

``init(ranks=...)`` restricts the job to a subset of the launched
processes (reference ``basics.py:155-165``): members get their position
in the subset as rank and a process group of their own; every other
process becomes an inactive world of one.

Every rank announces the coordination epoch it runs under
(``HOROVOD_COORD_EPOCH``) at the rendezvous, and rank 0's is the job's:
a rank that announces another epoch (a straggler from before a
coordinator failover) is dropped there and its ``init`` raises, while
the rest of the world forms without it (reference ``controller.cc:102-
165``, in its words).

``init`` also starts the control plane (:mod:`horovod_tpu_torch.native`)
that every eager ``hvd.*`` collective goes through, at every size: a gloo
control group and a data group of its own (NCCL on the GPU), created in
the same order on every rank, and the runtime's thread.  ``shutdown``
stops the thread (every rank agrees) and joins it before it destroys the
groups.

When the launcher runs a health plane (``HOROVOD_HEALTH_RPC``), ``init``
starts the heartbeat sender under this rank (reference
``basics.py:203-217``); it beats until the process ends or a later
``init`` replaces it.  ``world_epoch`` (the in-process
reformations this world has been through) and ``coordinator`` (the
launcher's ``HOROVOD_COORD_*`` trio) are the reference's
``basics.py:275-286`` and ``:392-412``.
"""

from __future__ import annotations

import atexit
import os
import socket
import threading
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import config, telemetry
from horovod_tpu_torch.native import coord_tree
from horovod_tpu_torch.native.runtime import CONTROL_TIMEOUT, Runtime
from horovod_tpu_torch.utils.logging import get_logger

log = get_logger("horovod_tpu_torch.controller")

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
        # The group this job's collectives span (None = the default
        # group) and the torch.distributed rank of each hvd rank in it.
        self.group: Optional[dist.ProcessGroup] = None
        self.global_ranks: Tuple[int, ...] = (0,)
        self.runtime = None
        self.world_epoch = 0


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


def _rendezvous_addr(size: int) -> Tuple[str, int]:
    coord = config.env_raw("HOROVOD_COORDINATOR_ADDR")
    if coord:
        host, port = coord.rsplit(":", 1)
        return host.strip("[]"), int(port)
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])
    if size == 1:
        return "127.0.0.1", _free_localhost_port()
    raise RuntimeError(
        f"a world of size {size} needs a rendezvous address: set "
        f"HOROVOD_COORDINATOR_ADDR=host:port or MASTER_ADDR/MASTER_PORT")


_EPOCH_KEY = "hvd/coord_epoch"
_STALE_KEY = "hvd/stale"


def _rendezvous(rank: int, size: int):
    """The store every rank meets at (rank 0 serves it), after the epoch
    check: rank 0 publishes its epoch; any other rank whose epoch differs
    leaves a note for rank 0 and raises instead of joining."""
    host, port = _rendezvous_addr(size)
    store = dist.TCPStore(host, port, None, rank == 0,
                          dist.constants.default_pg_timeout,
                          wait_for_workers=False, multi_tenant=True)
    epoch = config.env_int("HOROVOD_COORD_EPOCH")
    if rank == 0:
        store.set(_EPOCH_KEY, str(epoch))
        return store
    current = int(store.get(_EPOCH_KEY))
    if current != epoch:
        note = (f"controller: dropped rank {rank} announcing stale "
                f"coordination epoch {epoch} (current epoch {current})")
        n = store.add(_STALE_KEY, 1)
        store.set(f"{_STALE_KEY}/{n}", note)
        raise RuntimeError(note)
    return store


def _report_stale(store) -> None:
    """Rank 0: log the stragglers the rendezvous dropped."""
    for i in range(1, store.add(_STALE_KEY, 0) + 1):
        log.warning("%s", store.get(f"{_STALE_KEY}/{i}").decode())


def init(device=None, ranks: Optional[Sequence[int]] = None) -> None:
    """Initialize horovod_tpu_torch (reference ``basics.py:90``).

    ``device`` defaults to ``cuda:<local_rank>``; pass ``"cpu"`` to run on
    the CPU over gloo.  Topology resolution follows the JAX package: the
    ``HOROVOD_*`` env contract, with local = global and one host when the
    launcher exported nothing.  ``ranks`` restricts the job to those
    launched ranks (taken sorted, as a process set's are); every
    launched process must call ``init`` with the same ``ranks``.
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
        members = None
        if ranks is not None:
            members = sorted({int(r) for r in ranks})
            if not members or members[0] < 0 or members[-1] >= size:
                raise ValueError(f"init(ranks={list(ranks)}): ranks must be "
                                 f"in [0, {size})")
        dev = resolve_device(device, local_rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        store = _rendezvous(rank, size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=size)
        if rank == 0:
            _report_stale(store)
        group, global_ranks = None, tuple(range(size))
        if members is not None:
            group, global_ranks = _subset_group(rank, size, members)
            ctrl, _ = _subset_group(rank, size, members, "gloo",
                                    CONTROL_TIMEOUT)
            data, _ = _subset_group(rank, size, members, backend)
            rank, size = global_ranks.index(rank), len(global_ranks)
        else:
            ctrl = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
            data = dist.new_group(backend=backend)
        tree = None
        plan = None if members is not None else coord_tree.plan_from_env(
            rank, size, config.env_bool("HOROVOD_SCHEDULE_CHECK"))
        if plan is not None:
            tree = coord_tree.TreeGroups(plan, rank, global_ranks,
                                         CONTROL_TIMEOUT)
        try:
            runtime = Runtime(rank, size, ctrl, data, global_ranks, dev,
                              subset=members is not None, tree=tree)
        except BaseException:
            # The timeline or the trial log could not be opened: no half
            # world is left behind.
            dist.destroy_process_group()
            raise
        runtime.start()
        _state.rank, _state.size = rank, size
        _state.local_rank, _state.local_size = local_rank, local_size
        _state.cross_rank, _state.cross_size = cross_rank, cross_size
        _state.device = dev
        _state.group, _state.global_ranks = group, global_ranks
        _state.runtime = runtime
        _state.world_epoch = config.env_int("HOROVOD_WORLD_EPOCH", 0) or 0
        _state.initialized = True
    # The coordination epoch this rank runs under: after a failover the
    # merged metrics show every rank on the new one.
    telemetry.gauge(
        "hvd_coord_epoch",
        "Coordinator lease epoch this process is operating under").set(
        float(config.env_int("HOROVOD_COORD_EPOCH")))
    if config.env_raw("HOROVOD_HEALTH_RPC"):
        # The launcher's health plane listens: push heartbeats from now on.
        from horovod_tpu_torch import resilience
        resilience.start_heartbeat(rank=_state.rank)


def _subset_group(rank: int, size: int, members: List[int],
                  backend: Optional[str] = None, timeout=None):
    """The group of a rank-subset job: the members' group for a member,
    a group of its own for any other process.  Creating a group is
    collective over the default group, so every process creates every
    one of them, in the same order."""
    groups = {tuple(members): dist.new_group(members, timeout,
                                             backend=backend)}
    for r in range(size):
        if r not in members:
            groups[(r,)] = dist.new_group([r], timeout, backend=backend)
    key = tuple(members) if rank in members else (rank,)
    return groups[key], key


_shutdown_hooks: List[Callable[[], None]] = []


def on_shutdown(fn: Callable[[], None]) -> None:
    """Have :func:`shutdown` call ``fn``: a module built on the process
    group forgets what it holds of it (process sets, handles)."""
    _shutdown_hooks.append(fn)


def shutdown() -> None:
    """Stop the control plane and tear down the process groups ``init``
    created (reference ``basics.py:211``).  After a peer left (the
    runtime latched a membership change) an NCCL world is aborted, not
    destroyed: destroying waits on the dead peer.

    The heartbeat, unlike the reference's, goes on until the process ends
    or the next ``init`` replaces it: the rank is alive while it waits
    for its peers to agree to shut down and tears its groups down, and a
    launcher that heard nothing for its deadline then would kill it as
    dead at the end of a run that succeeded."""
    with _state.lock:
        if not _state.initialized:
            return
        runtime = _state.runtime
        runtime.stop()
        for fn in _shutdown_hooks:
            fn()
        abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
        if (dist.is_initialized() and runtime.membership_changed
                and abort is not None and dist.get_backend() == "nccl"):
            abort()
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


def world_epoch() -> int:
    """Membership epoch of the current world: 0 at launch, one more for
    every in-process reformation this process survived (fail-in-place);
    ``HOROVOD_WORLD_EPOCH`` as ``init`` found it."""
    _check_initialized()
    return _state.world_epoch


class CoordinatorInfo(NamedTuple):
    """The control-plane coordinator as the launcher last exported it
    (``HOROVOD_COORD_RANK`` / ``_EPOCH`` / ``_ELECTIONS``)."""
    rank: int
    epoch: int
    elections: int


def coordinator() -> CoordinatorInfo:
    """The current coordinator identity, read fresh from the environment
    on every call (the launcher re-exports it on each restart attempt);
    works before ``init``."""
    return CoordinatorInfo(
        rank=config.env_int("HOROVOD_COORD_RANK"),
        epoch=config.env_int("HOROVOD_COORD_EPOCH"),
        elections=config.env_int("HOROVOD_COORD_ELECTIONS"))


def runtime():
    """The control plane every eager collective is submitted to."""
    _check_initialized()
    return _state.runtime


def device() -> torch.device:
    """The device this process drives."""
    _check_initialized()
    return _state.device


def process_group() -> Optional[dist.ProcessGroup]:
    """The group this job's collectives span (None = the default group)."""
    _check_initialized()
    return _state.group


def global_rank(hvd_rank: int) -> int:
    """The ``torch.distributed`` rank of ``hvd_rank`` (they differ only
    under ``init(ranks=...)``)."""
    _check_initialized()
    return _state.global_ranks[hvd_rank]


def num_devices() -> int:
    """Devices the job's collectives span (reference ``basics.py:431``).
    One process drives one device here, so it is the world size."""
    _check_initialized()
    return _state.size


def local_devices() -> List[torch.device]:
    """The devices this process drives (reference ``basics.py:439``)."""
    _check_initialized()
    return [_state.device]


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
    """The reference's host map (``basics.py:325-379``): the launcher's
    ``HOROVOD_TOPOLOGY`` when its slots add up to the live world size,
    else uniform blocks from the LOCAL/CROSS contract (cross_size hosts of
    local_size slots, rank = host * local_size + local_rank, the last
    host taking the remainder of a world that does not divide), named
    ``HOROVOD_HOSTNAME``."""
    spec = config.env_str("HOROVOD_TOPOLOGY").strip()
    hosts: list = []
    if spec:
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                name, slots = part.rsplit(":", 1)
                hosts.append((name, int(slots)))
            else:
                hosts.append((part, 1))
        if sum(s for _, s in hosts) != size:
            hosts = []
    if not hosts:
        name = config.env_str("HOROVOD_HOSTNAME")
        for h in range(max(cross_size, 1)):
            slots = (min(local_size, size - h * local_size) if local_size > 0
                     else size)
            if slots <= 0:
                break
            hosts.append((name, slots))
    leaders, base = [], 0
    for _, slots in hosts:
        leaders.append(base)
        base += slots
    host_idx, host_start, host_slots = 0, 0, size
    for i, ((_, slots), start) in enumerate(zip(hosts, leaders)):
        if start <= rank < start + slots:
            host_idx, host_start, host_slots = i, start, slots
            break
    hostname = (hosts[host_idx][0] if hosts
                else config.env_str("HOROVOD_HOSTNAME"))
    return Topology(
        hosts=tuple(hosts), hostname=hostname, leaders=tuple(leaders),
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
    return build_mesh(_state.group)


# ---------------------------------------------------------------------------
# Build-capability queries (reference ``basics.py:478-515``), answered for
# this port: its collectives are torch.distributed's NCCL and gloo.
# ---------------------------------------------------------------------------

def mpi_threads_supported() -> bool:
    return False


def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def gloo_built() -> bool:
    return dist.is_gloo_available()


def gloo_enabled() -> bool:
    """True when this job's collectives run on gloo (a CPU world)."""
    return _state.initialized and dist.get_backend(_state.group) == "gloo"


def nccl_built() -> bool:
    return dist.is_nccl_available()


def ddl_built() -> bool:
    return False


def mlsl_built() -> bool:
    return False


def tpu_built() -> bool:
    return False


def tpu_enabled() -> bool:
    return False
