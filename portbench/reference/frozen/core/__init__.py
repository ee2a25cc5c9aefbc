"""World state, vehicle dynamics and geometry (port of ``cilrs_tpu/core``)."""
