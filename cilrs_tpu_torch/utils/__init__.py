"""Utilities: structured logging and device profiling (port of ``cilrs_tpu/utils``)."""

from cilrs_tpu_torch.utils.logging import get_logger  # noqa: F401
from cilrs_tpu_torch.utils.profiling import StepTimer, trace  # noqa: F401
