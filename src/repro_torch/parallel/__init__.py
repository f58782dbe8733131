"""Parallelism settings of the port (the one-device part of the JAX
package's ``parallel/``): the config and the per-arch presets.  Sharding
rules, meshes and ``DeviceMesh`` come with the multi-device slice."""
