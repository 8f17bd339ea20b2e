"""Party roles of the vertically federated runtime: the counterpart of
``repro/federation/mesh_roles.py``.

The JAX package runs every party in one SPMD program, with the parties as
the ``"model"`` axis of a device mesh, and a party learns its id from
``jax.lax.axis_index`` inside ``shard_map``.  The port runs the parties in
one process on one card, as column ranges of one table: ``PartyLayout``
says which columns party ``p`` owns (``tabular.even_partition``: the
contiguous columns ``[p * d_party, (p + 1) * d_party)``), and it is the only
code of the port that maps a party to its columns.  Party 0 is the active
party (the label holder); the others are passive.

The JAX package's data axis (``-sharded`` backends) shards the rows over a
second mesh axis and ``psum``s every per-shard partial.  On the one card
the ``S`` data shards are contiguous row ranges (``DataLayout``): shard
``s`` holds rows ``[s * m, (s + 1) * m)`` with ``m = ceil(n / S)`` (the
rows pad to ``S * m`` with weight-0 rows).  Each ``psum`` is a sum of the
shard partials in shard order 0..S-1.

``FederatedTable`` is a forest build's data: the one (n_pad, d) table with
both layouts.  A (shard, party) block is a view of it, never a copy, and one
histogram launch over the table serves every block: each party's histogram
is a column range of the full-width one, and each shard's partial a node
range once ``row_shard`` is folded into the node ids
(``aggregator._local_histograms``); one routing pass over the table
makes every block's map (``aggregator.federated_round_route_fn``, with
``PartyLayout.owner``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.data import tabular

PARTY_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"


@dataclasses.dataclass(frozen=True)
class PartyLayout:
    """Which of ``num_features`` columns each of ``num_parties`` parties
    owns: even contiguous ranges, party 0 first."""

    num_parties: int
    num_features: int
    partition: tabular.VerticalPartition = dataclasses.field(
        init=False, repr=False, compare=False)
    #: ``owner``'s lookup, one a device
    _owners: dict = dataclasses.field(
        init=False, repr=False, compare=False, default_factory=dict)

    def __post_init__(self):
        if self.num_parties < 1:
            raise ValueError(f"need >= 1 party, got {self.num_parties}")
        object.__setattr__(self, "partition", tabular.even_partition(
            self.num_features, self.num_parties))

    @property
    def party_dims(self) -> tuple:
        """Each party's column count, party 0 first."""
        return self.partition.dims()

    def columns(self, party: int) -> slice:
        return self.partition.columns(party)

    def party_index(self, feature: int) -> int:
        """The party that owns global column ``feature``."""
        return self.partition.owner_of(feature)

    def parts(self, x: torch.Tensor, dim: int) -> list:
        """Each party's columns of ``x`` along ``dim``, party 0 first, as
        views."""
        return list(torch.split(x, self.party_dims, dim=dim))

    def owner(self, feature: torch.Tensor) -> torch.Tensor:
        """The party that owns each global column id of ``feature`` (int64;
        -1 for -1, no column): one lookup into a (d + 1,) table made once a
        device, entry 0 for -1."""
        lut = self._owners.get(feature.device)
        if lut is None:
            lut = torch.tensor(
                [-1] + [p for p, w in enumerate(self.party_dims)
                        for _ in range(w)], device=feature.device)
            self._owners[feature.device] = lut
        return lut[feature + 1]


@functools.lru_cache(maxsize=32)
def even_layout(num_parties: int, num_features: int) -> PartyLayout:
    """``PartyLayout(num_parties, num_features)``, made once: the providers
    ask for it at every level."""
    return PartyLayout(num_parties, num_features)


@dataclasses.dataclass(frozen=True)
class DataLayout:
    """``num_shards`` even contiguous row ranges (the data axis)."""

    num_shards: int = 1

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"need >= 1 data shard, got {self.num_shards}")

    def padded_rows(self, n: int) -> int:
        """``n`` rounded up to a multiple of the shard count."""
        return -(-n // self.num_shards) * self.num_shards

    def rows(self, n: int) -> tuple:
        """Each shard's slice of ``n`` (padded) rows, shard 0 first."""
        if n % self.num_shards:
            raise ValueError(f"{n} rows do not split into "
                             f"{self.num_shards} shards; pad them first")
        m = n // self.num_shards
        return tuple(slice(s * m, (s + 1) * m)
                     for s in range(self.num_shards))


@dataclasses.dataclass(frozen=True)
class FederatedTable:
    """One forest build's federated data, what the federated providers take
    where the centralized ones take ``binned``: the (n_pad, d) int32
    ``table`` (never copied here), its ``parties`` and ``data`` layouts,
    ``rows``, each shard's row slice, and ``row_shard``, each row's shard
    as (n_pad,) int32 (None on one shard)."""

    table: torch.Tensor
    parties: PartyLayout
    data: DataLayout
    rows: tuple
    row_shard: Optional[torch.Tensor]

    @classmethod
    def of(cls, table: torch.Tensor, parties: PartyLayout,
           data: DataLayout = DataLayout()) -> "FederatedTable":
        if table.shape[1] != parties.num_features:
            raise ValueError(f"binned has {table.shape[1]} columns, the "
                             f"layout {parties.num_features}")
        n = table.shape[0]
        rows = data.rows(n)
        row_shard = None
        if data.num_shards > 1:
            row_shard = torch.arange(n, dtype=torch.int32,
                                     device=table.device) // (
                                         n // data.num_shards)
        return cls(table, parties, data, rows, row_shard)

    def blocks(self, shard: int) -> list:
        """The parties' blocks of shard ``shard``'s rows, party 0 first, as
        views of the table."""
        return self.parties.parts(self.table[self.rows[shard]], 1)


def shard_sum(parts) -> torch.Tensor:
    """The data axis's ``psum``: the shard partials summed in shard order
    0..S-1."""
    parts = list(parts)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def num_parties(layout: PartyLayout) -> int:
    return layout.num_parties
