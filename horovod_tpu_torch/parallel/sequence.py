"""Sequence attention.

Counterpart of ``horovod_tpu/parallel/sequence.py``; only
``local_attention`` (``:501``) is ported so far.  It is the transformer's
``attention="local"`` route and the plain oracle the flash kernels are held
to in the model.  Ring and Ulysses attention are ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

from typing import Optional

import torch


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Plain single-device attention over ``[B, T, H, D]``, computed in the
    inputs' dtype as the reference does (scores, softmax and the value
    product all in ``q.dtype``).

    ``segment_ids`` ([B, T] integer) enables sequence packing: tokens
    attend only within their own segment (composes with ``causal``).
    """
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    t = q.shape[1]
    allowed = None
    if causal:
        allowed = torch.ones((t, t), dtype=torch.bool,
                             device=q.device).tril()[None, None]
    if segment_ids is not None:
        seg_ok = (segment_ids[:, None, :, None] ==
                  segment_ids[:, None, None, :])
        allowed = seg_ok if allowed is None else (allowed & seg_ok)
    if allowed is not None:
        s = s.masked_fill(~allowed, float("-inf"))
    if segment_ids is not None:
        # Fully masked rows yield zeros with zero gradients: guard before
        # the softmax, whose all -inf row is NaN both ways (reference
        # :522-530).
        row_valid = allowed.any(dim=-1, keepdim=True)
        s = torch.where(row_valid, s, torch.zeros((), dtype=s.dtype,
                                                  device=s.device))
        p = torch.where(row_valid, torch.softmax(s, dim=-1),
                        torch.zeros((), dtype=s.dtype, device=s.device))
    else:
        p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
