"""I/O layer: console banner (VTK, metrics and checkpoints are not ported
yet; convert.load_jax_checkpoint reads the JAX package's checkpoints)."""
