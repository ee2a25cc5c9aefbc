"""A frozen copy of the simulator, the CILRS model and the scoring of
``cilrs_tpu_torch`` as they stood when the benchmark was defined, as plain
PyTorch: the sin hashes run their torch-op versions (``ops/sinf.py``), the
route search its Python Dijkstra (``maps/routing.py``), and the weather table
is read from ``configs/`` beside this file. It imports nothing of the program,
so a later change to the program cannot move what the benchmark holds it to.
Module names and functions are the program's; docstrings that speak of
kernels describe the program, not this copy.
"""
