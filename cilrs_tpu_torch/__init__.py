"""CILRS in PyTorch and CUDA for an NVIDIA H100: the port of ``cilrs_tpu``.

The JAX package ``cilrs_tpu`` is the reference and stays as it is. This
package keeps its module names (``ops/gather.py``, ``models/cilrs.py``,
``evaluation/report.py`` ...) so each module's counterpart is easy to find,
imports ``torch`` and numpy but nothing of JAX or of ``cilrs_tpu``, and reads
the shared ``configs/train.json``.

Every entry point takes a ``device`` that defaults to ``"cuda"`` and raises
when no GPU is present; the tests pass ``device="cpu"``. The row-gather that
``cilrs_tpu`` wrote in Pallas for the TPU is a hand-written CUDA kernel here
(``csrc/gather_rows.cu``), built with nvcc at first use.
"""

from cilrs_tpu_torch.config import TrainConfig, load_train_config  # noqa: F401
