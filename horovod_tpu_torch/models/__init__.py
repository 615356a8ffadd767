"""Models of the PyTorch port (ResNet v1.5 so far)."""

from horovod_tpu_torch.models.registry import get_model  # noqa: F401
