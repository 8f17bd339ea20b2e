"""Vertical partitioning of tabular data across parties (Table 1 / FATE-style):
a copy of ``repro/data/tabular.py``, which loads no JAX, kept here so the
port imports no module of the JAX package.

In VFL every party holds the same rows (after private-set-intersection
alignment, which we model as an id-sorted join) but a disjoint *column* slice.
The active party (party 0) additionally holds the labels.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class VerticalPartition(NamedTuple):
    """Column ownership: party p owns columns [offsets[p], offsets[p+1])."""

    offsets: tuple  # len = num_parties + 1, offsets[0] == 0
    num_features: int

    @property
    def num_parties(self) -> int:
        return len(self.offsets) - 1

    def columns(self, party: int) -> slice:
        return slice(self.offsets[party], self.offsets[party + 1])

    def owner_of(self, feature: int) -> int:
        """Which party owns a global feature index."""
        for p in range(self.num_parties):
            if self.offsets[p] <= feature < self.offsets[p + 1]:
                return p
        raise IndexError(feature)

    def dims(self) -> tuple:
        return tuple(
            self.offsets[p + 1] - self.offsets[p] for p in range(self.num_parties)
        )


def partition_from_dims(dims: Sequence[int]) -> VerticalPartition:
    offsets = [0]
    for d in dims:
        offsets.append(offsets[-1] + int(d))
    return VerticalPartition(offsets=tuple(offsets), num_features=offsets[-1])


def even_partition(num_features: int, num_parties: int) -> VerticalPartition:
    """Equal column shards — the layout the shard_map runtime uses, where the
    party axis is a mesh axis and every shard must have identical width.
    Features are padded (by the caller) when d % parties != 0."""
    if num_features % num_parties != 0:
        raise ValueError(
            f"{num_features} features do not shard evenly over {num_parties} "
            "parties; pad columns first (see pad_features)."
        )
    w = num_features // num_parties
    return partition_from_dims([w] * num_parties)


def pad_features(x: np.ndarray, num_parties: int) -> tuple[np.ndarray, int]:
    """Right-pad with constant columns so d % num_parties == 0.

    Constant columns can never be chosen by split finding (zero gain), so
    padding is semantically inert; returns (padded_x, d_padded).
    """
    n, d = x.shape
    rem = (-d) % num_parties
    if rem == 0:
        return x, d
    pad = np.zeros((n, rem), dtype=x.dtype)
    return np.concatenate([x, pad], axis=1), d + rem


def load_csv(
    path: str,
    label_col: str | int = -1,
    train_frac: float = 0.7,
    seed: int = 0,
    max_rows: int | None = None,
):
    """Real tabular loader: a labelled CSV → the ``synthetic.Dataset`` shape.

    Grounds the benchmarks' AUC deltas on real data (the synthetic credit
    generator stays the CI default — see ``benchmarks/comm_bench.py
    --dataset``).  numpy-only on purpose: no pandas dependency.

    Args:
      path: CSV file with one header row; numeric feature columns.  Blank /
        non-numeric cells load as NaN (the binning path is NaN-safe:
        nanquantile edges + the dedicated NAN_BIN).
      label_col: header name or column index of the binary/regression
        label (default: the last column).
      train_frac: train share of the 7:3-style shuffled split (paper §4.1).
      seed: shuffle seed.
      max_rows: optional row cap (subsampled after shuffle).

    Returns:
      ``synthetic.Dataset`` (x_train, y_train, x_test, y_test,
      name, active_dims) with active_dims = ceil(d / 2) — the Table-1-style
      "active party holds about half the columns" default; callers doing a
      real vertical split re-partition with ``partition_from_dims``.
    """
    from repro_torch.data.synthetic import Dataset  # local: numpy-only

    with open(path) as f:
        header = f.readline().strip().split(",")
    raw = np.genfromtxt(path, delimiter=",", skip_header=1, dtype=np.float64)
    if raw.ndim == 1:
        raw = raw[:, None]
    if isinstance(label_col, str):
        if label_col not in header:
            raise ValueError(
                f"label column {label_col!r} not in CSV header {header}"
            )
        label_idx = header.index(label_col)
    else:
        label_idx = label_col % len(header)
    y = raw[:, label_idx].astype(np.float32)
    x = np.delete(raw, label_idx, axis=1).astype(np.float32)
    keep = ~np.isnan(y)
    x, y = x[keep], y[keep]

    rng = np.random.default_rng(seed)
    perm = rng.permutation(x.shape[0])
    if max_rows is not None:
        perm = perm[:max_rows]
    x, y = x[perm], y[perm]
    k = int(train_frac * x.shape[0])
    name = path.rsplit("/", 1)[-1]
    return Dataset(
        x_train=x[:k], y_train=y[:k], x_test=x[k:], y_test=y[k:],
        name=f"csv:{name}", active_dims=(x.shape[1] + 1) // 2,
    )


def aligned_intersection(ids_a: np.ndarray, ids_b: np.ndarray) -> np.ndarray:
    """Private-set-intersection stand-in: sorted intersection of sample ids.

    The real protocol (Liang & Chawathe 2004) reveals only the intersection;
    computationally that is exactly np.intersect1d, which is what both sides
    end up ordering their rows by.
    """
    return np.intersect1d(ids_a, ids_b)
