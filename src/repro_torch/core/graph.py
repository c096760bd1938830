"""Graph representations for the subgraph-matching engine.

Four coupled views of one vertex-labeled undirected graph:

* CSR (``indptr``/``indices``)    — cache-friendly neighbor iteration and
  the layout every segment-op / SpMM kernel consumes.
* packed adjacency bitmaps        — ``[V, ceil(V/32)]`` uint32 words so the
  Eq. 2 candidate refinement becomes a vectorized bitwise-AND reduction
  (the CUDA ``bitmap_refine`` kernel operates on this view). Packed
  directly from CSR — the dense ``[V, V]`` boolean intermediate the old
  builder materialized is O(V²).
* per-vertex neighbor sets        — Python ``set`` view used only by the
  faithful sequential reference (Algorithms 1 and 2).

The matching engine treats graphs as immutable once built.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

WORD_BITS = 32


def pack_bitmap(dense: np.ndarray) -> np.ndarray:
    """Pack a boolean matrix [R, V] into uint32 words [R, ceil(V/32)].

    Bit ``j`` of word ``w`` of row ``r`` is ``dense[r, w*32 + j]``
    (little-endian bit order within each word).
    """
    dense = np.asarray(dense, dtype=bool)
    r, v = dense.shape
    n_words = (v + WORD_BITS - 1) // WORD_BITS
    padded = np.zeros((r, n_words * WORD_BITS), dtype=bool)
    padded[:, :v] = dense
    bits = padded.reshape(r, n_words, WORD_BITS)
    weights = (np.uint32(1) << np.arange(WORD_BITS, dtype=np.uint32))
    return (bits.astype(np.uint32) * weights).sum(axis=2, dtype=np.uint32)


def pack_bitmap_csr(n: int, indptr: np.ndarray,
                    indices: np.ndarray) -> np.ndarray:
    """Pack adjacency straight from CSR into uint32 [n, ceil(n/32)].

    O(E) time and O(n·W) output memory — no dense [n, n] boolean
    intermediate (that is 4 GB of bools at n=64K before packing even
    starts). Same bit order as :func:`pack_bitmap`.
    """
    n_words = (n + WORD_BITS - 1) // WORD_BITS
    words = np.zeros((n, max(n_words, 1)), dtype=np.uint32)
    cols = np.asarray(indices, dtype=np.int64)
    if cols.size:
        deg = np.asarray(indptr[1:], np.int64) - np.asarray(
            indptr[:-1], np.int64)
        rows = np.repeat(np.arange(n, dtype=np.int64), deg)
        np.bitwise_or.at(
            words, (rows, cols // WORD_BITS),
            np.uint32(1) << (cols % WORD_BITS).astype(np.uint32))
    return words


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable vertex-labeled undirected graph.

    Attributes:
      n:        number of vertices (ids are 0..n-1).
      labels:   int32 [n] vertex labels in 0..n_labels-1.
      indptr:   int32 [n+1] CSR row pointers.
      indices:  int32 [nnz] CSR column indices (sorted within each row).
      n_labels: size of the label alphabet.
    """

    n: int
    labels: np.ndarray
    indptr: np.ndarray
    indices: np.ndarray
    n_labels: int

    # ---- constructors -------------------------------------------------
    @staticmethod
    def from_edges(n: int, edges: Iterable[tuple[int, int]],
                   labels: Sequence[int], n_labels: int | None = None
                   ) -> "Graph":
        labels = np.asarray(labels, dtype=np.int32)
        assert labels.shape == (n,)
        src, dst = [], []
        seen = set()
        for a, b in edges:
            if a == b:
                continue  # no self loops in simple graphs
            key = (min(a, b), max(a, b))
            if key in seen:
                continue
            seen.add(key)
            src += [a, b]
            dst += [b, a]
        src_a = np.asarray(src, dtype=np.int32)
        dst_a = np.asarray(dst, dtype=np.int32)
        order = np.lexsort((dst_a, src_a))
        src_a, dst_a = src_a[order], dst_a[order]
        indptr = np.zeros(n + 1, dtype=np.int32)
        np.add.at(indptr, src_a + 1, 1)
        indptr = np.cumsum(indptr, dtype=np.int32)
        if n_labels is None:
            n_labels = int(labels.max(initial=-1)) + 1
        return Graph(n=n, labels=labels, indptr=indptr.astype(np.int32),
                     indices=dst_a, n_labels=int(n_labels))

    # ---- cached derived views -----------------------------------------
    def __post_init__(self):
        object.__setattr__(self, "_nbr_sets", None)
        object.__setattr__(self, "_nbr_sorted", None)
        object.__setattr__(self, "_bitmap", None)
        object.__setattr__(self, "_label_index", None)

    @property
    def degrees(self) -> np.ndarray:
        return self.indptr[1:] - self.indptr[:-1]

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    @property
    def neighbor_sorted(self) -> list[np.ndarray]:
        """Sorted neighbor arrays (CSR rows are already sorted)."""
        if self._nbr_sorted is None:
            rows = [np.sort(self.neighbors(v)) for v in range(self.n)]
            object.__setattr__(self, "_nbr_sorted", rows)
        return self._nbr_sorted

    @property
    def adj_bitmap(self) -> np.ndarray:
        """Packed adjacency bitmap, uint32 [n, ceil(n/32)].

        Packed straight from CSR (O(E)); the old dense [n, n] boolean
        intermediate was O(V²) and alone exceeded host memory before
        the device copy at the scale bench's 64K-vertex point.
        """
        if self._bitmap is None:
            object.__setattr__(
                self, "_bitmap",
                pack_bitmap_csr(self.n, self.indptr, self.indices))
        return self._bitmap

    @property
    def label_index(self) -> dict[int, np.ndarray]:
        """label -> sorted array of vertices with that label."""
        if self._label_index is None:
            idx: dict[int, np.ndarray] = {}
            order = np.argsort(self.labels, kind="stable")
            sorted_labels = self.labels[order]
            bounds = np.searchsorted(sorted_labels,
                                     np.arange(self.n_labels + 1))
            for lab in range(self.n_labels):
                idx[lab] = np.sort(order[bounds[lab]:bounds[lab + 1]]
                                   ).astype(np.int32)
            object.__setattr__(self, "_label_index", idx)
        return self._label_index

    def has_edge(self, a: int, b: int) -> bool:
        row = self.neighbors(a)
        i = np.searchsorted(row, b)
        return bool(i < len(row) and row[i] == b)

    @property
    def n_edges(self) -> int:
        return int(len(self.indices) // 2)

    def degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])

    # ---- neighbor label multiset signature (GraphQL-style filter) ------
    @property
    def neighbor_label_counts(self) -> np.ndarray:
        """[n, n_labels] int32 — count of each label among neighbors."""
        counts = np.zeros((self.n, self.n_labels), dtype=np.int32)
        src = np.repeat(np.arange(self.n, dtype=np.int32), self.degrees)
        np.add.at(counts, (src, self.labels[self.indices]), 1)
        return counts
