"""Data parallelism over ``torch.distributed``: process-group
initialization, the mesh and its collectives, and the sharded fleet (port of
``cilrs_tpu/parallel/``)."""

from cilrs_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch  # noqa: F401
