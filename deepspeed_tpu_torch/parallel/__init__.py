"""Topology and device mesh of the port (``parallel/topology.py``,
``parallel/mesh.py``). The JAX package's head-sharded kernel wraps
(``parallel/pallas_shard.py``) wait for tensor parallelism."""
