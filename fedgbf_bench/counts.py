"""The least time of the work a cell does, from the problem's shapes alone,
and the peaks it is measured against: part of the yardstick, so a change
to the program cannot change them.

Every count here is a function of the data's shape and of the algorithm
the configuration states: each input byte read once, each output byte
written once, and the operations the algorithm needs.  Columns a layout
pads on are not counted: they are no part of the problem.  None depends
on how the program lays out its work (parties, row shards, launches a
level), so a program that fuses or re-splits its kernels leaves every
numerator the same.
"""

from __future__ import annotations

from typing import NamedTuple

#: NVIDIA H100 SXM, dense, from NVIDIA's data sheet (at the 700 W limit).
PEAK_FLOPS_F32 = 67e12        # FLOP/s, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # B/s

F32 = I32 = 4                 # bytes of an element


def least_time_s(flops: float, nbytes: float) -> float:
    """The larger of the operations at the float32 peak and the bytes at
    the HBM rate."""
    return max(flops / PEAK_FLOPS_F32, nbytes / HBM_BYTES_PER_S)


class JobShape(NamedTuple):
    """What one training job hands the program and asks of it."""

    n: int                    # rows
    d: int                    # the data's columns (no padding counted)
    trees: tuple              # trees of each round
    keep: tuple               # sampled rows of each round's trees
    depth: int
    num_bins: int
    subtraction: bool         # right siblings derived as parent - left


def nodes_accumulated(level: int, subtraction: bool) -> int:
    """Histograms a tree must accumulate at a level: every node, or under
    sibling subtraction only the left children (one a parent)."""
    if level == 0 or not subtraction:
        return 2 ** level
    return 2 ** (level - 1)


def histogram_level(shape: JobShape, trees: int, keep: int,
                    level: int) -> tuple[float, float]:
    """(operations, bytes) that one level of one round adds to the inputs
    read once a job and once a round (``histogram_round``): each tree's
    node assignment (n,) int32 read once from level 1 on, since the
    previous level's splits make it and no earlier pass can read it (at
    level 0 every row is at the root); the histograms (trees, nodes, d,
    B, 3) float32 written once.  Operations: 3 adds (g, h, weight) a
    sampled row and column of each tree where the level accumulates every
    node; under subtraction the left children's rows depend on the
    splits, and 0 is counted there (the bytes bind by far anyway)."""
    n, d = shape.n, shape.d
    nodes = nodes_accumulated(level, shape.subtraction)
    assignment = trees * n * I32 if level else 0
    nbytes = assignment + trees * nodes * d * shape.num_bins * 3 * F32
    direct = level == 0 or not shape.subtraction
    flops = 3.0 * trees * keep * d if direct else 0.0
    return flops, float(nbytes)


def histogram_round(shape: JobShape, r: int) -> tuple[float, float]:
    """(operations, bytes) of round ``r``'s histograms: g and h (n,)
    float32 and each tree's sample weight (n,) float32, new every round,
    read once; then every level's own (``histogram_level``)."""
    trees = shape.trees[r]
    flops, nbytes = 0.0, float(2 * shape.n * F32 + trees * shape.n * F32)
    for level in range(shape.depth):
        f, b = histogram_level(shape, trees, shape.keep[r], level)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


def histogram_job(shape: JobShape) -> tuple[float, float]:
    """(operations, bytes) of a job's histogram work: the bins (n, d)
    int32, which no round changes, read once a job, and every round's
    own (``histogram_round``)."""
    flops, nbytes = 0.0, float(shape.n * shape.d * I32)
    for r in range(len(shape.trees)):
        f, b = histogram_round(shape, r)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


def histogram_job_least_s(shape: JobShape) -> float:
    """Least time of a job's histogram work."""
    return least_time_s(*histogram_job(shape))


def job_io_bytes(shape: JobShape) -> float:
    """A job's inputs read once and outputs written once: raw features
    (n, d) and labels (n,) float32, every tree's sample mask (n,) float32
    and feature mask (d,) bool; every tree's node tables (feature,
    threshold int32, gain float32 a node; a float32 weight a leaf) and the
    final margins (n,) float32."""
    n, d = shape.n, shape.d
    builds = sum(shape.trees)
    internal, leaves = 2 ** shape.depth - 1, 2 ** shape.depth
    return float(n * d * F32 + n * F32 + builds * (n * F32 + d)
                 + builds * (internal * 3 * 4 + leaves * F32) + n * F32)


def job_flops(shape: JobShape) -> float:
    """A job's operations: the histogram adds, 10 a gain candidate (every
    node, column and bin of every tree), 8 a row for g and h, and 2 a row
    and tree for the margin update."""
    flops = histogram_job(shape)[0]
    for t in shape.trees:
        nodes = 2 ** shape.depth - 1
        flops += 10.0 * t * nodes * shape.d * shape.num_bins
        flops += 8.0 * shape.n + 2.0 * t * shape.n
    return flops


def job_least_s(shape: JobShape) -> float:
    """Least time of a whole job: its operations at the float32 peak or
    its input and output bytes at the HBM rate, whichever is longer."""
    return least_time_s(job_flops(shape), job_io_bytes(shape))


def batch_bytes(rows: int, d: int, n_trees: int, depth: int) -> float:
    """A scoring batch: the rows (rows, d) float32 read once; every tree's
    feature (int32) and value threshold (float32) a node, its leaves and
    its scale (float32) read once; the scores (rows,) float32 written
    once."""
    internal, leaves = 2 ** depth - 1, 2 ** depth
    return float(rows * d * F32
                 + n_trees * (internal * (I32 + F32) + leaves * F32 + F32)
                 + rows * F32)


def batch_flops(rows: int, n_trees: int, depth: int) -> float:
    """A compare a level and a multiply-add (2) a tree for each row, and 4
    for the sigmoid."""
    return float(rows * n_trees * (depth + 2) + 4 * rows)


def batch_least_s(rows: int, d: int, n_trees: int, depth: int) -> float:
    return least_time_s(batch_flops(rows, n_trees, depth),
                        batch_bytes(rows, d, n_trees, depth))
