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
        return PartyBlocks(tuple(
            binned[:, self.columns(p)].contiguous()
            for p in range(self.num_parties)))


class PartyBlocks(tuple):
    """The parties' (n, d_party) column blocks, party 0 first: what the
    federated providers take where the centralized ones take ``binned``."""


def num_parties(layout: PartyLayout) -> int:
    return layout.num_parties
