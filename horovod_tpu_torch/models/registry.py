"""Name -> model-constructor registry (reference ``models/registry.py``),
so the benchmark selects a model by name.  VGG and Inception are not
ported yet."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(name: str, ctor: Callable) -> None:
    _REGISTRY[name.lower()] = ctor


def get_model(name: str, **kwargs):
    try:
        ctor = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return ctor(**kwargs)


def _register_defaults():
    from horovod_tpu_torch.models import resnet
    register("resnet18", resnet.ResNet18)
    register("resnet34", resnet.ResNet34)
    register("resnet50", resnet.ResNet50)
    register("resnet101", resnet.ResNet101)
    register("resnet152", resnet.ResNet152)


_register_defaults()
