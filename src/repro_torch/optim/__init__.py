"""Optimizer, learning-rate schedules and int8 weight quantization of the
port (twins of the JAX package's ``optim/``)."""
