"""Gradient-histogram accumulation: the CUDA kernel
(``csrc/histogram.cu``), its plain versions (``ref``) and its wrappers
(``ops``)."""
