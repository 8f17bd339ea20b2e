"""PyTorch/CUDA port of FedGBF: centralized training (uniform and GOSS
sampling, kill-and-resume from train-state checkpoints), vertically
federated training (``federation/``), serving (f32 and int8/int16
quantized ensembles), and the LM substrate (``models/``, ``configs/``,
``optim/``, ``data/tokens.py``, ``launch/{train,serve}.py``: ten
architectures, AdamW training and KV-cache serving).

A package beside the JAX package ``repro``, which stays the reference.  It
imports ``torch`` and never ``jax`` or any ``repro.*`` module: what it needs
of the JAX package's JAX-free modules (``obs``, ``data.synthetic``,
``data.tabular``, ``data.tokens``, ``core.dynamic``, the model configs) it
keeps as its own copies, and ``core.explain`` and ``core.runtime_model`` as
copies over its own types.  Module names follow the JAX package, so each
module's counterpart is found at the same path under ``src/repro/``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve``); the hand-written kernels
under ``kernels/`` (the training histogram, the ensemble traversals) run
only on the card, and a CPU tensor takes each kernel's plain PyTorch
version.  The LM substrate reaches no kernel of the JAX package's, so it
is plain PyTorch on either device.
"""
