"""Datasets: a copy of the JAX package's numpy-only ``data/synthetic.py``,
so request streams are identical element for element."""
