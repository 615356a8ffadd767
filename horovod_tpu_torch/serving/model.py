"""Decode models for the serving plane.

Counterpart of ``horovod_tpu/serving/model.py``.  A replica drives any
object with the three methods of :class:`DecodeModel`; :class:`ToyModel`
is the contract's reference implementation, the next token a function
of the previous token, the position and a checksum of the weights, so
that a test can assert exact tokens and see a hot weight update flip a
stream.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from horovod_tpu_torch import basics


class DecodeModel:
    """What a serving replica drives.

    ``decode_step`` takes one ``(last_token, position)`` pair per live
    sequence and returns each one's next token: one token-level step of
    the whole running batch, where continuous batching joins and leaves.
    ``weights`` and ``generation`` are the hot-update surface; the
    replica swaps both at a step boundary, never inside a step.
    """

    #: Deployment counter, bumped by every hot weight update.
    generation: int = 0

    def decode_step(self, batch: Sequence[Tuple[int, int]]) -> List[int]:
        raise NotImplementedError

    def set_weights(self, weights, generation: int) -> None:
        raise NotImplementedError

    def get_weights(self):
        raise NotImplementedError


def host_weights(weights) -> np.ndarray:
    """Weights as a float32 host array (a tensor is copied off its
    device): what the checksum reads and what crosses the RPC wire."""
    if isinstance(weights, torch.Tensor):
        return weights.detach().to("cpu", torch.float32).numpy()
    return np.asarray(weights, np.float32)


class ToyModel(DecodeModel):
    """``next = (31*token + 7*pos + checksum(w)) % vocab``, deterministic
    (a step retried on another replica gives the same token), sensitive
    to the weights' generation, and stateless across steps.

    The weights are a float32 tensor on ``device`` (the card unless the
    caller asks for the CPU).  The checksum is taken once per
    :meth:`set_weights` from the host copy, in the reference's arithmetic
    (numpy's float32 sum): a reduction on the card may sum in another
    order, and one ulp would change every token.  The weights change only
    there, so this is the checksum of every step.  A step computes its
    tokens on the device in int64, from tokens and positions reduced
    modulo the vocabulary on the host (the same residue as the
    reference's Python integers, with no overflow), and returns Python
    ints.
    """

    VOCAB = 50257

    def __init__(self, weights=None, generation: int = 0, device=None):
        self.device = basics.resolve_device(device)
        if weights is None:
            weights = np.arange(8, dtype=np.float32)
        self.set_weights(weights, generation)

    def _checksum(self) -> int:
        return self._sum

    def set_weights(self, weights, generation: int) -> None:
        host = host_weights(weights)
        self._sum = int(abs(float(host.sum()))) % self.VOCAB
        if isinstance(weights, torch.Tensor):
            self._weights = weights.detach().to(self.device, torch.float32)
        else:
            self._weights = torch.as_tensor(host).to(self.device)
        self.generation = int(generation)

    def decode_step(self, batch: Sequence[Tuple[int, int]]) -> List[int]:
        if not batch:
            return []
        v = self.VOCAB
        pairs = torch.tensor([(int(tok) % v, int(pos) % v)
                              for tok, pos in batch], dtype=torch.int64)
        pairs = pairs.to(self.device)
        nxt = (31 * pairs[:, 0] + 7 * pairs[:, 1] + self._sum) % v
        return nxt.tolist()

    def get_weights(self) -> torch.Tensor:
        return self._weights
