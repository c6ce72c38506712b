"""Hand-written CUDA kernels of the port and their plain versions
(``flash_attention``: K1–K3 of ``ddl_tpu/ops/flash_attention.py``)."""
