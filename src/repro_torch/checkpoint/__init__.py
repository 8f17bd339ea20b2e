"""Checkpoint I/O in the JAX package's npz + json sidecar format."""
