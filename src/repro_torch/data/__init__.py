"""Data pipelines of the port (twin of the JAX package's ``data/``)."""
