"""Utilities: structured logging, the program's spans and device profiling
(port of ``cilrs_tpu/utils``)."""

from cilrs_tpu_torch.utils.logging import get_logger  # noqa: F401
from cilrs_tpu_torch.utils.profiling import reset_spans, span, span_summary, trace  # noqa: F401
