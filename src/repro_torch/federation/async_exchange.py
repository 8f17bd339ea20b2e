"""Double-buffered level exchange: the counterpart of
``repro/federation/async_exchange.py``.

The JAX package splits the per-level histogram payload along the bin axis
into two independent all_gathers, which XLA lowers to overlapping
asynchronous collectives.  The split is along an axis that is not
gathered, so the re-joined result equals the single gather element for
element.  The port keeps the same seam and the same split: two
concatenations over the parties, one per half of the bins, joined back on
the bin axis.  ``vfl.make_vfl_backend`` passes this gather to the raw or
the quantized histogram provider (``-async``; the quantized one buffers
its int payload, the scales ship whole).  The meter records the payload
ONCE, before the split: the double buffer is a detail of the transport,
not a second message, so the ledger stays exact.
"""

from __future__ import annotations

import torch

from repro_torch.federation import aggregator


def double_buffered_gather(parts, axis: int,
                           split_axis: int = -2) -> torch.Tensor:
    """Gather the parties' payloads along ``axis`` as two transfers: each
    payload split at the midpoint of ``split_axis`` (the bin axis), the
    halves gathered separately and joined back.  Payloads with fewer than
    two entries on ``split_axis`` take the plain gather."""
    parts = list(parts)
    extent = parts[0].shape[split_axis]
    if extent < 2:
        return aggregator.plain_gather(parts, axis)
    halves = [torch.split(p, [extent // 2, extent - extent // 2],
                          dim=split_axis) for p in parts]
    lo = aggregator.plain_gather([a for a, _ in halves], axis)
    hi = aggregator.plain_gather([b for _, b in halves], axis)
    return torch.cat([lo, hi], dim=split_axis)
