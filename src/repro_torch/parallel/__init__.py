"""Parallelism of the port (the twin of the JAX package's ``parallel/``):
the config and the per-arch presets, the logical-axis sharding rules and
their DTensor placements (``rules``), the ambient parallel context with
its activation constraints (``ctx``), and GPipe stages over a mesh axis
(``pipeline``).  Meshes are built in ``launch/mesh.py``."""
