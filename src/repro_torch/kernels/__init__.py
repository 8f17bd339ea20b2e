"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version.  ``build.py`` compiles the sources at first use."""
