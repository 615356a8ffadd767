"""Models of the PyTorch port: ResNet v1.5, VGG-BN and Inception-v3
(through the registry, as the reference's ``models/__init__.py``
exports them) and the transformer LM (``models.transformer``)."""

from horovod_tpu_torch.models.inception import InceptionV3  # noqa: F401
from horovod_tpu_torch.models.registry import (  # noqa: F401
    get_model, list_models)
from horovod_tpu_torch.models.resnet import (  # noqa: F401
    ResNet, ResNet18, ResNet34, ResNet50, ResNet101, ResNet152)
from horovod_tpu_torch.models.vgg import (  # noqa: F401
    VGG, VGG11, VGG13, VGG16, VGG19)
