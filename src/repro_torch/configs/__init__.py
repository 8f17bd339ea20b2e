"""Architecture registry, copied from the JAX package's ``repro.configs``
with identical values and ``source`` strings: one module per architecture,
each exporting ``config()`` (the full configuration) and ``smoke_config()``
(a reduced variant of the same family: <= 3 layers, d_model <= 512, <= 4
experts)."""

from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config  # noqa: F401
