"""Checkpointing of the port (twin of the JAX package's ``checkpoint/``)."""
