"""Vectorised sum-tree (segment tree) for proportional prioritized replay.

Parity: reference `rainbowiqn/memory.py` `SegmentTree` (SURVEY.md §2 row 5;
algorithm: Schaul et al. arXiv:1511.05952).  The reference walks the tree one
node at a time in Python; at the build's target throughput that pointer-chase
is the bottleneck (SURVEY.md §7 "hard parts"), so this implementation stores
the tree as one flat array and performs *batched* updates and *batched*
stratified sampling — every tree level is one vectorised NumPy op over the
whole batch.  A C++ core (`native.py`) implements the same layout for the
hot path; this module is the reference implementation and fallback.

Layout: classic implicit binary heap over a power-of-two leaf span.
  tree[1] = root (total priority); children of i are 2i, 2i+1;
  leaves occupy [span, span + capacity).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class SumTree:
    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.span = 1 << (capacity - 1).bit_length()  # next power of two
        self.tree = np.zeros(2 * self.span, dtype=np.float64)
        # float64: at 1e6 leaves, fp32 partial sums drift enough to break the
        # invariant root == sum(leaves) under millions of incremental updates.

    # ------------------------------------------------------------------ totals
    @property
    def total(self) -> float:
        return float(self.tree[1])

    def max_leaf(self, filled: Optional[int] = None, lanes: int = 1) -> float:
        """Max leaf priority, clamped to WRITTEN slots when the caller's
        ring geometry is given: ``filled`` is the per-lane written count and
        ``lanes`` the lane count of a multi-lane ring (lane ``l`` owns the
        contiguous leaf block ``[l*seg, l*seg + seg)``, written prefix
        ``filled``).  Without the clamp the scan covers never-written slots
        too — a restored/partially rebuilt tree whose unwritten span carries
        residue would leak it into the fresh-item default priority
        (``max_priority`` re-seeding after restore/readmission)."""
        leaves = self.tree[self.span : self.span + self.capacity]
        if filled is not None:
            seg = self.capacity // max(int(lanes), 1)
            filled = min(int(filled), seg)
            mask = (np.arange(self.capacity) % max(seg, 1)) < filled
            leaves = leaves[mask]
        return float(leaves.max()) if leaves.size else 0.0

    def min_leaf_nonzero(self) -> float:
        leaves = self.tree[self.span : self.span + self.capacity]
        nz = leaves[leaves > 0]
        return float(nz.min()) if nz.size else 0.0

    def get(self, idx: np.ndarray) -> np.ndarray:
        """Leaf priorities at data indices ``idx``."""
        return self.tree[self.span + np.asarray(idx)]

    # ----------------------------------------------------------------- updates
    def set(self, idx: np.ndarray, priority: np.ndarray) -> None:
        """Batched leaf assignment + ancestor fix-up, one op per tree level.

        Duplicate indices are allowed; the LAST write wins (matching the
        sequential semantics of the reference's per-item loop).
        """
        idx = np.asarray(idx, dtype=np.int64).ravel()
        priority = np.broadcast_to(
            np.asarray(priority, dtype=np.float64).ravel(), idx.shape
        )
        if idx.size == 0:
            return
        if np.any(priority < 0) or not np.all(np.isfinite(priority)):
            raise ValueError("priorities must be finite and non-negative")

        # Resolve duplicates: keep the last occurrence of each index.
        if idx.size > 1:
            _, last_pos = np.unique(idx[::-1], return_index=True)
            keep = idx.size - 1 - last_pos
            idx, priority = idx[keep], priority[keep]

        nodes = self.span + idx
        delta = priority - self.tree[nodes]
        self.tree[nodes] = priority
        nodes >>= 1
        while nodes[0] >= 1:
            # Siblings updated in the same batch collapse via add.at (sums
            # duplicate node contributions), keeping ancestors exact.
            np.add.at(self.tree, nodes, delta)
            nodes >>= 1
        # note: nodes[0] reaches 0 only after the root (1) was updated.

    # ---------------------------------------------------------------- sampling
    def find_prefix(self, mass: np.ndarray) -> np.ndarray:
        """Batched prefix-sum descent: for each mass m in [0, total), find the
        leaf i with  sum(leaves[:i]) <= m < sum(leaves[:i+1]).

        One vectorised step per tree level (log2(span) steps total).
        """
        mass = np.asarray(mass, dtype=np.float64).copy()
        node = np.ones_like(mass, dtype=np.int64)
        while node[0] < self.span:  # all nodes are on the same level
            node <<= 1  # left child
            left = self.tree[node]
            go_right = mass >= left
            mass -= np.where(go_right, left, 0.0)
            node += go_right
        leaf = node - self.span
        # Guard against fp edge-fall onto a zero-priority / out-of-range leaf.
        return np.minimum(leaf, self.capacity - 1)

    def sample_stratified(
        self, batch_size: int, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray]:
        """PER stratified sampling: one uniform draw per equal slice of total
        mass (reference behaviour, SURVEY §2 row 5). Returns (idx, prob)."""
        total = self.total
        if total <= 0:
            raise ValueError("cannot sample from an empty tree")
        seg = total / batch_size
        mass = (np.arange(batch_size) + rng.random(batch_size)) * seg
        idx = self.find_prefix(mass)
        prob = self.get(idx) / total
        return idx, prob
