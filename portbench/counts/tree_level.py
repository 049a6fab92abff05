"""The least bytes and operations of growing histogram trees level by level.

Each input byte is counted once a level and each output byte once, whatever
a kernel reads again, and only what these inputs need, each at the least
width that holds it: a level reads the codes of the features it scans (one
byte a code up to 256 bins, two up to 65,536), g and h (8 bytes, float32)
of every row it accumulates and, below the root, the node id of every row
(one byte up to 256 nodes, else two), and writes its (node, feature, bin)
sums of g and h (8 bytes a cell) and each node's decision (gain, feature,
bin: 12 bytes). Below the root, histogram subtraction needs the rows of the
smaller child of each sibling pair only, and reads the parent's sums
instead of the larger child's rows. The leaf sums read g, h and the leaf of
every row and write 8 bytes a leaf. Operations: two adds a (row, scanned
feature), about 12 a candidate split (two prefix sums, three quotients,
their squares and the gain).
"""
from __future__ import annotations

import torch


def width(n_values: int) -> int:
    """The least whole bytes that tell ``n_values`` values apart."""
    return max(1, (max(n_values - 1, 1).bit_length() + 7) // 8)


def level_bytes(rows_read: int, n_rows: int, n_features: int, n_nodes: int,
                n_bins: int, subtract: bool) -> int:
    cells = n_nodes * n_features * n_bins
    node_ids = n_rows * width(n_nodes) if n_nodes > 1 else 0
    b = rows_read * (width(n_bins) * n_features + 8) + node_ids + cells * 8 + n_nodes * 12
    if subtract:
        b += (n_nodes // 2) * n_features * n_bins * 8
    return b


def level_flops(rows_read: int, n_features: int, n_nodes: int, n_bins: int) -> int:
    return 2 * rows_read * n_features + 12 * n_nodes * n_features * n_bins


def leaf_sum_bytes(n_rows: int, n_leaves: int) -> int:
    return n_rows * (8 + width(n_leaves)) + n_leaves * 8


def tree_work(level_counts, n_rows: int, n_features: int, n_bins: int) -> tuple[int, int]:
    """(bytes, operations) of one tree whose level l held ``level_counts[l]``
    rows in each of its 2^l nodes (levels 0 .. D-1), grown with subtraction
    below the root, plus its leaf sums."""
    total_b = total_f = 0
    for level, counts in enumerate(level_counts):
        n_nodes = 1 << level
        if level == 0:
            rows = n_rows
        else:
            rows = int(torch.minimum(counts[0::2], counts[1::2]).sum())
        total_b += level_bytes(rows, n_rows, n_features, n_nodes, n_bins, level > 0)
        total_f += level_flops(rows, n_features, n_nodes, n_bins)
    total_b += leaf_sum_bytes(n_rows, 1 << len(level_counts))
    total_f += 2 * n_rows
    return total_b, total_f
