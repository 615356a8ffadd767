"""Replica worker: one model served over the RPC plane.

Counterpart of ``horovod_tpu/serving/replica.py``.  A replica is one rank
of a serving job holding one copy of the weights and answering the
router's token-level ``decode`` requests.

* **Authenticated transport**: :meth:`ReplicaWorker.attach` serves
  :meth:`ReplicaWorker.handle` on an
  :class:`~horovod_tpu_torch.runner.rpc.RpcServer` under the job's HMAC
  key, with ``serialize=False`` so that ``ping`` and ``stats`` answer
  while a decode step runs; weight swaps take the worker's own lock.
* **Hot weight updates**: :func:`broadcast_weights` hands a new weight
  generation to every rank through ``hvd.broadcast`` (NCCL on the card,
  gloo on the CPU); a non-root rank sits in the collective on its main
  thread while its RPC threads go on serving.  The update is staged
  (:meth:`ReplicaWorker.stage_update`) and applied at the next decode
  step's boundary, never inside a step and with no restart, so no
  request in flight is dropped.
* **Chaos**: every decode step polls
  :func:`horovod_tpu_torch.faults.crash_replica`; a firing kills the
  replica mid-request, as a real crash would (the request in flight gets
  no response), which is what the router's retry is tested against.

:func:`load_replica_model` reads
:func:`horovod_tpu_torch.checkpoint.load_local`, the local half of the
checkpoint plane with no collective.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.serving.model import DecodeModel

DECODE_TIME_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                       0.1, 0.25, 0.5, 1.0, 2.5)


class ReplicaCrashed(RuntimeError):
    """Raised in the RPC handler when a ``replica_crash`` rule fires: the
    connection closes with no response, as a real crash looks to the
    router."""


def _staged(weights):
    """A staged weight copy: a float32 tensor stays where it is (the
    model moves it to its device), anything else becomes a host array."""
    if isinstance(weights, torch.Tensor):
        return weights.detach().to(dtype=torch.float32)
    return np.asarray(weights, np.float32)


class ReplicaWorker:
    """One serving replica: model, staged-update slot and RPC handler.

    ``step_time`` adds a simulated cost to each step; ``on_crash`` runs
    after a chaos crash marked the worker dead (a standalone process
    passes ``os._exit``; the default shuts an attached RPC server down).
    """

    def __init__(self, model: DecodeModel, *, replica_id: str = "r0",
                 step_time: float = 0.0,
                 on_crash: Optional[Callable[[], None]] = None):
        self.model = model
        self.replica_id = replica_id
        self.step_time = float(step_time)
        self._on_crash = on_crash
        self._lock = threading.Lock()
        self._pending = None          # staged (weights, generation)
        self._decode_steps = 0
        self._dead = False
        self._server = None

    # -- hot updates -------------------------------------------------------

    def stage_update(self, weights, generation: int) -> int:
        """Stage a weight generation; it goes live at the next decode
        step's boundary.  Returns the staged generation."""
        gen = int(generation)
        staged = _staged(weights)
        with self._lock:
            self._pending = (staged, gen)
        if telemetry.enabled():
            telemetry.counter(
                "hvd_serving_weight_updates_total",
                "Hot weight updates staged on this replica").inc()
        return gen

    def _apply_pending_locked(self) -> None:
        if self._pending is None:
            return
        weights, gen = self._pending
        self._pending = None
        self.model.set_weights(weights, gen)
        if telemetry.enabled():
            telemetry.gauge(
                "hvd_serving_weight_generation",
                "Live weight generation on this replica").set(float(gen))

    # -- decode ------------------------------------------------------------

    def _crash(self) -> None:
        with self._lock:
            self._dead = True
        if telemetry.enabled():
            telemetry.counter(
                "hvd_serving_replica_crashes_total",
                "Chaos replica_crash firings on this replica").inc()
        if self._on_crash is not None:
            self._on_crash()
        elif self._server is not None:
            # From a helper thread: shutdown() joins the serve loop, and
            # this may run on one of its request threads.
            srv = self._server
            threading.Thread(target=srv.shutdown, daemon=True).start()
        raise ReplicaCrashed(f"replica {self.replica_id} chaos crash")

    def decode(self, seqs) -> Dict[str, Any]:
        """One continuous-batching step: ``seqs`` is a list of
        ``(request_id, last_token, position)``; returns each request's
        next token.  A staged update is applied first, at the boundary."""
        if faults.crash_replica():
            self._crash()
        with self._lock:
            if self._dead:
                raise ReplicaCrashed(
                    f"replica {self.replica_id} is dead")
            self._apply_pending_locked()
            t0 = telemetry.clock()
            tokens = self.model.decode_step(
                [(tok, pos) for _, tok, pos in seqs])
            if self.step_time:
                time.sleep(self.step_time)
            self._decode_steps += 1
            gen = self.model.generation
        if telemetry.enabled():
            telemetry.counter(
                "hvd_serving_decode_steps_total",
                "Token-level decode steps executed by this replica").inc()
            telemetry.histogram(
                "hvd_serving_decode_seconds",
                "Wall time of one batched decode step",
                bounds=DECODE_TIME_BUCKETS).observe(
                telemetry.clock() - t0)
        sp = telemetry.spans()
        if sp is not None:
            sp.event(f"serving/decode.{self.replica_id}", "decode", t0,
                     telemetry.clock())
        return {"ok": True, "generation": gen,
                "tokens": {rid: tok for (rid, _, _), tok
                           in zip(seqs, tokens)}}

    # -- RPC surface -------------------------------------------------------

    def handle(self, req: Any) -> Any:
        """RPC dispatch on ``req["kind"]``: ``ping``, ``stats``,
        ``decode`` or ``update_weights``."""
        kind = req.get("kind") if isinstance(req, dict) else None
        if kind == "ping":
            return {"ok": True, "replica": self.replica_id,
                    "generation": self.model.generation}
        if kind == "stats":
            with self._lock:
                return {"ok": True, "replica": self.replica_id,
                        "generation": self.model.generation,
                        "decode_steps": self._decode_steps,
                        "dead": self._dead}
        if kind == "decode":
            return self.decode(req["seqs"])
        if kind == "update_weights":
            gen = self.stage_update(req["weights"], req["generation"])
            return {"ok": True, "replica": self.replica_id,
                    "generation": gen}
        return {"ok": False, "error": f"unknown kind {kind!r}"}

    def attach(self, key: bytes, bind: str = "127.0.0.1"):
        """Serve :meth:`handle` on an authenticated
        :class:`~horovod_tpu_torch.runner.rpc.RpcServer` with concurrent
        handlers.  Returns the server."""
        from horovod_tpu_torch.runner import rpc
        self._server = rpc.RpcServer(key, self.handle, bind=bind,
                                     serialize=False)
        return self._server


def broadcast_weights(weights, generation: int, root_rank: int = 0,
                      name: str = "hvd.serving.weights"):
    """Hand a weight generation to every rank through the broadcast plane.

    Collective: every rank of the serving job calls it with weights of
    the same shape (a non-root rank passes its current copy and receives
    the root's).  Returns ``(weights, generation)`` as ``root_rank`` sent
    them, the weights a float32 tensor on this rank's ``hvd`` device;
    stage them with :meth:`ReplicaWorker.stage_update`.  The two
    broadcasts are named ``{name}.gen`` and ``{name}.g{generation}``, as
    the reference names them: the control plane pairs collectives by
    name across ranks.
    """
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import collective

    dev = basics.device()
    sp = telemetry.spans()
    t0 = telemetry.clock() if sp is not None else 0.0
    gen = torch.tensor([int(generation)], dtype=torch.int64, device=dev)
    gen = collective.broadcast(gen, root_rank=root_rank, name=f"{name}.gen")
    live_gen = int(gen[0])
    if isinstance(weights, torch.Tensor):
        w = weights.detach().to(dev, torch.float32)
    else:
        w = torch.as_tensor(np.asarray(weights, np.float32)).to(dev)
    out = collective.broadcast(w, root_rank=root_rank,
                               name=f"{name}.g{live_gen}")
    if sp is not None:
        # The hot update's umbrella span; the two broadcasts' spans nest
        # under it in the merged trace.
        sp.event(f"serving/weights.g{live_gen}", "broadcast", t0,
                 telemetry.clock(), int(out.numel() * out.element_size()))
    return out, live_gen


def load_replica_model(ckpt_dir: str, weights_template=None, device=None):
    """A :class:`~horovod_tpu_torch.serving.model.ToyModel` on ``device``
    from the newest intact checkpoint in ``ckpt_dir`` (a local read, no
    collective), or from the template's weights when there is none.  The
    checkpoint's step becomes the starting generation, so a deployment
    fed by a training job moves forward only."""
    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.serving.model import ToyModel

    if weights_template is None:
        weights_template = np.arange(8, dtype=np.float32)
    template = {"w": np.asarray(weights_template, np.float32)}
    state, step = checkpoint.load_local(ckpt_dir, template)
    return ToyModel(state["w"], generation=0 if step is None else step,
                    device=device)
