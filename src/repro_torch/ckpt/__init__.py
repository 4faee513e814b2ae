"""Checkpoints of the port's states, in the JAX package's on-disk format."""
