"""The benchmark of ``ddl_tpu_torch`` on NVIDIA cards: one command runs
one cell once (``python3 -m benchmark.run``; see ``benchmark/README.md``).

Nothing here imports the JAX package or JAX; only ``program.py`` and
``families/`` import the port, and only inside the functions that run it.
"""
