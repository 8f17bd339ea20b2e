"""Device choice for the port's entry points.

Entry points default to the CUDA card.  Nothing falls back to the CPU on
its own: without a card, a caller that did not ask for ``"cpu"`` gets an
error.
"""

from __future__ import annotations

import torch


def resolve(name: str | torch.device | None = None) -> torch.device:
    """The device to run on: ``name``, or ``cuda`` when it is None.

    Raises ``RuntimeError`` for a CUDA device when CUDA is not available.
    """
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
