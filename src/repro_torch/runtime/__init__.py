"""Training runtime of the port: the step builders and the training loop
(twins of the JAX package's ``runtime/``)."""
