"""PyTorch/CUDA port of FedGBF: centralized training and serving.

A package beside the JAX package ``repro``, which stays the reference.  It
imports ``torch`` and never ``jax`` or any ``repro.*`` module: what it needs
of the JAX package's JAX-free modules (``obs``, ``data.synthetic``,
``core.dynamic``) it keeps
as its own copies.  Module names follow the JAX package, so each module's
counterpart is found at the same path under ``src/repro/``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve``); the hand-written kernels
under ``kernels/`` (the training histogram, the ensemble traversals) run
only on the card, and a CPU tensor takes each kernel's plain PyTorch
version.  Federation, GOSS and quantized ensembles are not ported yet.
"""
