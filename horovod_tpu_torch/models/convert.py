"""Weights between the flax layout and the port's modules.

The port names its submodules and leaves as flax does, so a flax path
``("BottleneckBlock_3", "Conv_1", "kernel")`` is the state-dict key
``"BottleneckBlock_3.Conv_1.kernel"``.  What changes is layout: conv
kernels are HWIO in flax and OIHW here, dense kernels ``[in, out]`` in
flax and ``[out, in]`` here.  Arrays cross as numpy, so this module needs
neither framework's other half.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

_STAT_LEAVES = ("mean", "var")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _to_port(path: Tuple[str, ...], arr: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)       # HWIO -> OIHW
    if path[-1] == "kernel" and arr.ndim == 2:
        return arr.T                           # [in, out] -> [out, in]
    return arr


def _to_flax(path: Tuple[str, ...], arr: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel" and arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)       # OIHW -> HWIO
    if path[-1] == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of numpy arrays (flax
    layout) -> the port's ``state_dict``."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})):
            a = np.ascontiguousarray(_to_port(path, np.asarray(arr)))
            out[".".join(path)] = torch.from_numpy(a.copy())
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's ``state_dict`` -> ``{"params": ..., "batch_stats": ...}``
    nested dicts of numpy arrays in the flax layout."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        path = tuple(key.split("."))
        collection = "batch_stats" if path[-1] in _STAT_LEAVES else "params"
        node = out[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        arr = t.detach().to("cpu", torch.float32).numpy()
        node[path[-1]] = np.ascontiguousarray(_to_flax(path, arr))
    return out


def flax_ordered_parameters(model: torch.nn.Module
                            ) -> List[Tuple[str, torch.nn.Parameter]]:
    """``(name, parameter)`` in the order flax flattens the params dict
    (sorted keys at every level), so gradient leaves fall into the same
    fusion buckets as the reference's."""
    return sorted(model.named_parameters(),
                  key=lambda kv: tuple(kv[0].split(".")))
