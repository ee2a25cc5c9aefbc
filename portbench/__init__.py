"""The benchmark of ``cilrs_tpu_torch`` on one NVIDIA H100: one process runs
one cell once (``python -m portbench.run --workload CELL --seed N --seconds S
--trace 0|1``) and prints one JSON line. See ``README.md``."""
