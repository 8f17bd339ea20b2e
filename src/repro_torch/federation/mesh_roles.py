"""Party roles of the vertically federated runtime: the counterpart of
``repro/federation/mesh_roles.py``.

The JAX package runs every party in one SPMD program, with the parties as
the ``"model"`` axis of a device mesh, and a party learns its id from
``jax.lax.axis_index`` inside ``shard_map``.  The port runs the parties as
column blocks of one process on one card: party ``p`` holds the contiguous
columns ``[p * d_party, (p + 1) * d_party)`` of ``binned``
(``tabular.even_partition``), and the providers of ``federation/
aggregator.py`` loop over the blocks, so a party's id is its position in
``PartyBlocks``.  Party 0 is the active party (the label holder); the
others are passive.

The JAX package's data axis (``-sharded`` backends) shards the rows over a
second mesh axis and ``psum``s every per-shard partial.  On the one card
the ``S`` data shards are contiguous row blocks (``DataLayout``), as the
parties are column blocks: shard ``s`` holds rows ``[s * m, (s + 1) * m)``
with ``m = ceil(n / S)`` (the rows pad to ``S * m`` with weight-0 rows),
and ``ShardBlocks`` holds every (shard, party) block.  Each ``psum`` is a
sum of the shard partials in shard order 0..S-1.

Both kinds of blocks also carry the ``table`` they were cut from (no
copy), so that one histogram launch over it serves every block: each
party's histogram is a column slice of the full-width one, and each
shard's partial a node range once ``ShardBlocks.row_shard`` is folded into
the node ids (``aggregator._local_histograms``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.data import tabular

PARTY_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"


@dataclasses.dataclass(frozen=True)
class PartyLayout:
    """``num_parties`` even column blocks of ``num_features`` columns."""

    num_parties: int
    num_features: int

    def __post_init__(self):
        if self.num_parties < 1:
            raise ValueError(f"need >= 1 party, got {self.num_parties}")
        tabular.even_partition(self.num_features, self.num_parties)

    @property
    def d_party(self) -> int:
        return self.num_features // self.num_parties

    def columns(self, party: int) -> slice:
        return slice(party * self.d_party, (party + 1) * self.d_party)

    def party_index(self, feature: int) -> int:
        """The party that owns global column ``feature``."""
        if not 0 <= feature < self.num_features:
            raise IndexError(feature)
        return feature // self.d_party

    def split(self, binned: torch.Tensor) -> "PartyBlocks":
        """Each party's columns of ``binned`` (n, d) as its own contiguous
        (n, d_party) tensor: split once per forest build, never per level."""
        if binned.shape[1] != self.num_features:
            raise ValueError(f"binned has {binned.shape[1]} columns, the "
                             f"layout {self.num_features}")
        return PartyBlocks((binned[:, self.columns(p)].contiguous()
                            for p in range(self.num_parties)), binned)


class PartyBlocks(tuple):
    """The parties' (n, d_party) column blocks, party 0 first: what the
    federated providers take where the centralized ones take ``binned``.
    ``table`` is the (n, d) tensor they were cut from."""

    def __new__(cls, blocks, table: torch.Tensor):
        self = super().__new__(cls, blocks)
        self.table = table
        return self


@dataclasses.dataclass(frozen=True)
class DataLayout:
    """``num_shards`` even contiguous row blocks (the data axis)."""

    num_shards: int = 1

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"need >= 1 data shard, got {self.num_shards}")

    def padded_rows(self, n: int) -> int:
        """``n`` rounded up to a multiple of the shard count."""
        return -(-n // self.num_shards) * self.num_shards

    def split(self, binned: torch.Tensor,
              parties: PartyLayout) -> "ShardBlocks":
        """Every (shard, party) block of ``binned`` (n_pad, d), n_pad a
        multiple of the shard count, as its own contiguous tensor."""
        n = binned.shape[0]
        if n % self.num_shards:
            raise ValueError(f"{n} rows do not split into "
                             f"{self.num_shards} shards; pad them first")
        m = n // self.num_shards
        row_shard = torch.arange(n, dtype=torch.int32,
                                 device=binned.device) // m
        return ShardBlocks((parties.split(binned[s * m:(s + 1) * m])
                            for s in range(self.num_shards)), binned,
                           row_shard)


class ShardBlocks(tuple):
    """The data shards' ``PartyBlocks``, shard 0 first: each shard's rows
    split into the parties' column blocks.  ``table`` is the (n_pad, d)
    tensor they were cut from and ``row_shard`` (n_pad,) int32 each row's
    shard, both made once per forest build."""

    def __new__(cls, shards, table: torch.Tensor, row_shard: torch.Tensor):
        self = super().__new__(cls, shards)
        self.table = table
        self.row_shard = row_shard
        return self


def shard_rows(blocks, n: int) -> list:
    """``[(party_blocks, rows), ...]``, one a data shard in shard order:
    the shard's ``PartyBlocks`` and its slice of the ``n`` (padded) rows.
    Unsharded ``PartyBlocks`` are the one shard holding every row."""
    if not isinstance(blocks, ShardBlocks):
        return [(blocks, slice(None))]
    m = n // len(blocks)
    return [(shard, slice(s * m, (s + 1) * m))
            for s, shard in enumerate(blocks)]


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
