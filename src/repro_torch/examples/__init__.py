"""The JAX package's examples on the port: ``python -m
repro_torch.examples.<name>`` (on the card; ``--device cpu`` on the
CPU)."""
