"""Ensemble traversal: the CUDA kernels (``csrc/ensemble_predict.cu``),
their plain versions (``ref``) and their wrappers (``ops``)."""
