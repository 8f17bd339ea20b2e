"""Double-buffered level exchange: the counterpart of
``repro/federation/async_exchange.py``.

The JAX package splits the per-level histogram payload along the bin axis
into two independent all_gathers, which XLA lowers to overlapping
asynchronous collectives.  The split is along an axis that is not
gathered, so the re-joined result equals the single gather element for
element.  The port keeps the same seam and the same split: two
concatenations over the parties, one per half of the bins, joined back on
the bin axis.  The meter records the payload ONCE, before the split: the
double buffer is a detail of the transport, not a second message, so the
ledger stays exact.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from repro_torch.core import histogram as hist_mod
from repro_torch.federation import aggregator, compress


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


def async_round_histogram_fn(
    transport: Optional[compress.TransportSpec] = None,
    meter=None,
    base_fn: Callable = hist_mod.compute_round_histogram,
    draws: Optional[compress.Draws] = None,
    child: bool = False,
):
    """Histogram-aggregation round provider with the double-buffered
    exchange: the raw provider with the buffered gather, or the quantized
    one with its int payload buffered (the scales ship whole).  ``child``:
    ``base_fn`` is a child form."""
    if transport is None:
        transport = compress.RAW
    gather = partial(double_buffered_gather, split_axis=-2)
    if transport.kind == "quantized":
        return compress.quantized_round_histogram_fn(
            transport, meter=meter, base_fn=base_fn, gather=gather,
            draws=draws, child=child)
    if transport.kind == "raw":
        return aggregator.federated_round_histogram_fn(
            base_fn, meter=meter, gather=gather, child=child)
    raise ValueError(
        f"transport {transport.kind!r} does not apply to the async "
        "histogram exchange (use 'raw' or 'quantized')")
