"""Parallel layers of the port of ``ddl_tpu/parallel``: one-device
training steps and attention dispatch (``train``, ``ring_attention``),
meshes of positions and sharded arrays (``mesh``), and the ICI ingest
tier (``ici``)."""
