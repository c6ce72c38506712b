"""Hand-written CUDA kernels of the port and their plain versions
(``flash_attention``: K1–K6 of ``ddl_tpu/ops/flash_attention.py``;
``device_shuffle``: K9; ``ici_fanout``: K7–K8)."""
