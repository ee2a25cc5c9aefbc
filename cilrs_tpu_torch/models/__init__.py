"""CILRS policy in PyTorch: ResNet-34 trunk, CILRS heads, loss, weight conversion."""

from cilrs_tpu_torch.models.cilrs import CILRS  # noqa: F401
from cilrs_tpu_torch.models.losses import cilrs_loss  # noqa: F401
from cilrs_tpu_torch.models.resnet import ResNet34  # noqa: F401
