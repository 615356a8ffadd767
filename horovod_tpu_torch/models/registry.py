"""Name -> model-constructor registry (reference ``models/registry.py``),
so the benchmark selects a model by name, as the reference harness's
``--model`` flag does."""

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


def list_models():
    return sorted(_REGISTRY)


def _register_defaults():
    from horovod_tpu_torch.models import inception, resnet, vgg
    register("resnet18", resnet.ResNet18)
    register("resnet34", resnet.ResNet34)
    register("resnet50", resnet.ResNet50)
    register("resnet101", resnet.ResNet101)
    register("resnet152", resnet.ResNet152)
    register("vgg11", vgg.VGG11)
    register("vgg13", vgg.VGG13)
    register("vgg16", vgg.VGG16)
    register("vgg19", vgg.VGG19)
    register("inception3", inception.InceptionV3)
    register("inceptionv3", inception.InceptionV3)


_register_defaults()
