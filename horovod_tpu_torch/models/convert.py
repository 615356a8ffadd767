"""Weights between the flax layout and the port's modules.

The port names its submodules and leaves as flax does, so a flax path
``("BottleneckBlock_3", "Conv_1", "kernel")`` is the state-dict key
``"BottleneckBlock_3.Conv_1.kernel"``.  What changes is layout: conv
kernels are HWIO in flax and OIHW here, dense kernels ``[in, out]`` in
flax and ``[out, in]`` here.  Arrays cross as numpy, so this module needs
neither framework's other half.  The transformer LM's pytree crosses
with ``lm_params_to_torch`` and ``lm_state_dict_to_params``, and as
Megatron shards with ``lm_params_to_shards`` and ``lm_shards_to_params``,
and as a pipe rank's ``PipelineLM`` with ``lm_pipeline_to_rank`` and
``lm_rank_to_pipeline``.  A ZeRO-1 optimizer state crosses with
``zero_state_to_torch`` and ``zero_state_to_arrays``, and the MoE
example's parameters with ``moe_params_to_torch``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.distributed as dist

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


# The transformer LM's parameters are a pytree of dicts and one list
# (``{"embed", "pos", "ln_f_scale", "layers": [{...}, ...]}``), kept in the
# JAX ``[in, out]`` layout, so crossing is a copy and a rename:
# ``params["layers"][3]["wq"]`` is the parameter ``layers.3.wq``.

def _pytree_key(name: str):
    # A list index sorts by its value (the list's order), a dict key as a
    # string: with 10 layers "layers.10" sorts after "layers.9", as JAX
    # flattens the list, and not before "layers.2" as a string would.
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def lm_ordered_parameters(model: torch.nn.Module
                          ) -> List[Tuple[str, torch.nn.Parameter]]:
    """``(name, parameter)`` of the LM in ``jax.tree_util`` flatten order
    (dict keys sorted, list items by index), so the gradient leaves fall
    into the reference's fusion buckets."""
    return sorted(model.named_parameters(),
                  key=lambda kv: _pytree_key(kv[0]))


def lm_params_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """The LM's parameter pytree of numpy arrays -> the port's
    ``state_dict`` (``layers.<i>.<leaf>`` names, same layout)."""
    out = {}
    for key, value in params.items():
        if key == "layers":
            for i, layer in enumerate(value):
                for leaf, arr in layer.items():
                    out[f"layers.{i}.{leaf}"] = torch.from_numpy(
                        np.array(arr, dtype=np.float32))
        else:
            out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def lm_state_dict_to_params(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's LM ``state_dict`` -> the parameter pytree of numpy f32
    arrays (the inverse of :func:`lm_params_to_torch`)."""
    out: Dict = {}
    layers: Dict[int, Dict] = {}
    for key, t in state_dict.items():
        arr = t.detach().to("cpu", torch.float32).numpy().copy()
        parts = key.split(".")
        if parts[0] == "layers":
            layers.setdefault(int(parts[1]), {})[parts[2]] = arr
        else:
            out[key] = arr
    out["layers"] = [layers[i] for i in range(len(layers))]
    return out


def _lm_split_dims(n_layers: int, model_axis: str) -> Dict[str, int]:
    """The state-dict names of the leaves sharded over ``model_axis`` by
    ``param_specs``, with the dim each is split on."""
    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      param_specs)
    specs = param_specs(TransformerConfig(n_layers=n_layers), model_axis)
    flat = {k: v for k, v in specs.items() if k != "layers"}
    for i, layer in enumerate(specs["layers"]):
        flat.update({f"layers.{i}.{leaf}": v for leaf, v in layer.items()})
    return {name: spec.index(model_axis) for name, spec in flat.items()
            if model_axis in spec}


def lm_params_to_shards(params: Mapping, mesh, model_axis: str = "model"
                        ) -> Dict[str, torch.Tensor]:
    """The LM's full parameter pytree of numpy arrays -> this rank's
    ``state_dict`` of a ``TransformerLM(model_shards=...)``: each leaf
    that ``param_specs`` shards over ``model_axis`` split into the
    axis's size along its dim, this rank's piece (by its coordinate on
    the axis); every other leaf whole."""
    out = lm_params_to_torch(params)
    if model_axis is None:
        return out
    n, i = mesh.axis_size(model_axis), mesh.axis_index(model_axis)
    for name, dim in _lm_split_dims(len(params["layers"]),
                                    model_axis).items():
        out[name] = out[name].chunk(n, dim)[i].contiguous()
    return out


def lm_shards_to_params(state_dict: Mapping[str, torch.Tensor], mesh,
                        model_axis: str = "model") -> Dict:
    """The inverse of :func:`lm_params_to_shards`: the shards of every
    rank of the model axis gathered into the full pytree of numpy f32
    arrays.  Collective over the model axis: each of its ranks calls it
    with its own shards."""
    full = dict(state_dict)
    if model_axis is not None and mesh.axis_size(model_axis) > 1:
        group = mesh.axis(model_axis)
        n_layers = 1 + max(int(k.split(".")[1]) for k in state_dict
                           if k.startswith("layers."))
        for name, dim in _lm_split_dims(n_layers, model_axis).items():
            t = state_dict[name].detach().contiguous()
            parts = [torch.empty_like(t)
                     for _ in range(mesh.axis_size(model_axis))]
            dist.all_gather(parts, t, group=group)
            full[name] = torch.cat(parts, dim)
    return lm_state_dict_to_params(full)


# A pipe rank's ``PipelineLM`` holds the base leaves whole and its chunks'
# layers as ``chunks.<k>.<i>.<leaf>``: row ``p·v + k`` of every leaf of the
# reference's ``split_pipeline_params(params, P, v)["stacked"]`` (row p at
# ``v`` 1), whose layer i is the module's layer ``(k, i)``.

_BASE_LEAVES = ("embed", "ln_f_scale", "pos")


def lm_pipeline_ordered_parameters(model: torch.nn.Module
                                   ) -> List[Tuple[str, torch.nn.Parameter]]:
    """``(name, parameter)`` of a ``PipelineLM`` in ``jax.tree_util``
    flatten order of the reference's ``{"base", "stacked"}`` tree: the base
    leaves by name, then each stacked leaf by name, its rows (the chunks)
    and their layers in order."""
    from horovod_tpu_torch.models.transformer import LAYER_LEAVES
    out = [(n, getattr(model, n)) for n in _BASE_LEAVES]
    for leaf in sorted(LAYER_LEAVES):
        for k, chunk in enumerate(model.chunks):
            for i, layer in enumerate(chunk):
                out.append((f"chunks.{k}.{i}.{leaf}", getattr(layer, leaf)))
    return out


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def lm_pipeline_to_rank(split: Mapping, pipe_index: int, virtual: int = 1
                        ) -> Dict[str, torch.Tensor]:
    """``split_pipeline_params(params, P, virtual)`` of either package
    (numpy arrays or tensors) -> pipe rank ``pipe_index``'s ``PipelineLM``
    ``state_dict``: the base leaves whole, and rows ``[p·v, (p+1)·v)`` of
    every stacked leaf as its chunks' layers."""
    out = {k: _f32(v) for k, v in split["base"].items()}
    for leaf, rows in split["stacked"].items():
        rows = _f32(rows)
        for k in range(virtual):
            for i, w in enumerate(rows[pipe_index * virtual + k]):
                out[f"chunks.{k}.{i}.{leaf}"] = w
    return out


def lm_rank_to_pipeline(state_dict: Mapping[str, torch.Tensor], pipe_axis,
                        virtual: int = 1) -> Dict:
    """The inverse of :func:`lm_pipeline_to_rank`: every pipe rank's chunks
    gathered into the ``{"base", "stacked"}`` tree of numpy f32 arrays that
    ``split_pipeline_params(params, P, virtual)`` gives.  Collective over
    ``pipe_axis`` (the pipe group or a ``VirtualRank``): each of its ranks
    calls it with its own ``state_dict``."""
    from horovod_tpu_torch.models.transformer import LAYER_LEAVES
    from horovod_tpu_torch.parallel.sequence import all_gather

    def cpu(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    lpc = 1 + max(int(k.split(".")[2]) for k in state_dict
                  if k.startswith("chunks."))
    stacked = {}
    for leaf in LAYER_LEAVES:
        rows = torch.stack([torch.stack([state_dict[f"chunks.{k}.{i}.{leaf}"]
                                         for i in range(lpc)])
                            for k in range(virtual)])
        stacked[leaf] = cpu(all_gather(rows.contiguous(), pipe_axis, 0))
    return {"base": {k: cpu(state_dict[k]) for k in _BASE_LEAVES},
            "stacked": stacked}


# ---------------------------------------------------------------------------
# ZeRO-1 sharded state (horovod_tpu/parallel/zero.py's global layout).
# ---------------------------------------------------------------------------

def zero_state_to_torch(fields: Mapping, like, wire=None):
    """A ZeRO-1 state of the JAX package carried into the port: ``like``
    (a ``ZeroShardedState`` of the same plan, freshly ``init``-ed) with
    this rank's shard of each array.

    ``fields`` maps each parameter-shaped field of the optimizer's state
    (``"trace"``; ``"mu"`` and ``"nu"``) to its list of FULL padded
    bucket vectors (the global arrays of the reference's state), and may
    hold Adam's ``"count"``.  ``wire`` is the codec state in the
    reference's global layout, ``(rs, ag, factors)`` per bucket, None
    where it keeps nothing; the factors are PowerSGD's (the reference's
    draw, which the port's generator cannot reproduce)."""
    from horovod_tpu_torch.ops.compression import CodecState, local_state

    plan, index = like.plan, like.index

    def tensor(a, like_t):
        return _f32(a).to(like_t.device, like_t.dtype)

    inner = like.inner
    replace = {}
    for name in inner._fields:
        if name not in fields:
            continue
        cur = getattr(inner, name)
        if torch.is_tensor(cur):
            replace[name] = tensor(fields[name], cur).reshape(cur.shape)
        else:
            replace[name] = [
                plan.shard_slice(b, tensor(a, c).reshape(-1), index).clone()
                for b, (a, c) in enumerate(zip(fields[name], cur))]
    out = dataclasses.replace(like, inner=inner._replace(**replace))
    if wire is not None:
        dev = next((t.device for t in _tensors_of(like.wire)), None)
        rs, ag, factors = (
            [None if a is None else _f32(a).to(dev) for a in group]
            for group in wire)
        out = dataclasses.replace(out, wire=local_state(
            CodecState(rs, ag, factors), plan, index))
    return out


def _tensors_of(codec_state) -> List[torch.Tensor]:
    if codec_state is None:
        return []
    return [t for t in codec_state.rs + codec_state.ag
            + codec_state.factors if t is not None]


def zero_state_to_arrays(state) -> Tuple[Dict, object]:
    """The inverse of :func:`zero_state_to_torch`: every rank's shards
    gathered over the state's group into the reference's global layout,
    as numpy f32.  Returns ``(fields, wire)``: ``fields`` maps each field
    of the optimizer's state to its full bucket vectors (a scalar field
    as an array), ``wire`` is ``(rs, ag, factors)`` or None.  Collective:
    every rank of the group calls it."""
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.ops.compression import gather_state

    def cpu(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    fields = {}
    for name in state.inner._fields:
        cur = getattr(state.inner, name)
        if cur is None:
            continue
        if torch.is_tensor(cur):
            fields[name] = cpu(cur)
            continue
        fields[name] = [cpu(full) for full in fusion.wait_all(
            [fusion.start_all_gather(s, state.group) for s in cur])]
    wire = None
    if state.wire is not None:
        full = gather_state(state.wire, state.plan, state.group)
        wire = tuple([None if t is None else cpu(t) for t in group]
                     for group in (full.rs, full.ag, full.factors))
    return fields, wire


def moe_params_to_torch(params: Mapping, rank=None) -> Dict:
    """The MoE example's numpy parameters (``examples/jax_moe.py``:
    ``router [D, E]``, ``w1 [E, D, H]``, ``w2 [E, H, D]``, each expert's
    slice sharded over the expert axis) -> the port's: ``router`` and
    every other replicated leaf as a tensor, ``experts`` a list of
    ``{"w1": [D, H], "w2": [H, D]}`` by expert (dense layout: tokens
    times weight, as the reference).  ``rank`` keeps that expert alone:
    the parameters a rank of the expert axis holds."""
    out = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
           params.items() if k not in ("w1", "w2")}
    w1, w2 = np.asarray(params["w1"]), np.asarray(params["w2"])
    experts = [{"w1": torch.from_numpy(np.array(w1[e], np.float32)),
                "w2": torch.from_numpy(np.array(w2[e], np.float32))}
               for e in range(w1.shape[0])]
    out["experts"] = experts if rank is None else experts[rank]
    return out
