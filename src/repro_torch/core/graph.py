"""Graph representations for the subgraph-matching engine.

Four coupled views of one vertex-labeled undirected graph:

* CSR (``indptr``/``indices``)    — cache-friendly neighbor iteration and
  the layout every segment-op / SpMM kernel consumes.
* packed adjacency bitmaps        — ``[V, ceil(V/32)]`` uint32 words so the
  Eq. 2 candidate refinement becomes a vectorized bitwise-AND reduction
  (the CUDA ``bitmap_refine`` kernel operates on this view). Packed
  directly from CSR — the dense ``[V, V]`` boolean intermediate the old
  builder materialized is O(V²).
* hierarchical (two-level) bitmaps — :class:`HierBitmap`: per row a
  *summary* word (one bit per C-word chunk) plus a CSR-of-chunks store
  holding only the nonzero chunks. Memory is O(E), not O(V²/32); the
  CUDA ``bitmap_refine_hier`` kernel operates on this view, for graphs
  of 16384 or more vertices.
* per-vertex neighbor sets        — Python ``set`` view used only by the
  faithful sequential reference (Algorithms 1 and 2).

The matching engine treats graphs as immutable once built.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Sequence

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


class HierBitmap(NamedTuple):
    """Two-level (hierarchical) packed adjacency: a per-row summary
    bitmap over C-word chunks plus a CSR-of-chunks store of the nonzero
    chunks only.

    Chunk ``c`` of row ``v`` covers words ``[c*C, (c+1)*C)`` of the flat
    packed row, i.e. vertices ``[c*32C, (c+1)*32C)``. ``summary[v]`` has
    bit ``c`` set iff that chunk holds at least one neighbor; the chunk's
    C words are stored at ``chunk_data[k]`` for the unique ``k`` in
    ``[chunk_ptr[v], chunk_ptr[v+1])`` with ``chunk_id[k] == c``
    (``chunk_id`` ascending within each row). ``chunk_id``/``chunk_data``
    carry ``kmax`` rows of zero padding past ``n_stored`` so a kernel may
    over-read a fixed ``kmax``-chunk window from any row start.
    """
    summary: np.ndarray     # uint32 [V, ceil(n_chunks/32)]
    chunk_ptr: np.ndarray   # int32 [V+1] CSR offsets into chunk_id/_data
    chunk_id: np.ndarray    # int32 [n_stored + kmax] chunk index per entry
    chunk_data: np.ndarray  # uint32 [n_stored + kmax, C] packed words
    chunk_words: int        # C — words per chunk (power of two)
    n_chunks: int           # ceil(W / C) addressable chunks per row
    kmax: int               # max stored chunks on any row (>= 1)

    @property
    def n_stored(self) -> int:
        return int(self.chunk_id.shape[0] - self.kmax)

    @property
    def nbytes(self) -> int:
        return int(self.summary.nbytes + self.chunk_ptr.nbytes
                   + self.chunk_id.nbytes + self.chunk_data.nbytes)


def build_hier_bitmap(n: int, indptr: np.ndarray, indices: np.ndarray,
                      chunk_words: int = 8) -> HierBitmap:
    """Build the two-level layout from CSR in O(E) — neither the dense
    bitmap nor any per-row dense chunk table is materialized.

    ``chunk_words`` must be a power of two in [1, 128], as in the
    reference (whose TPU kernel relies on chunk boundaries dividing the
    128-lane padded row); other values are rejected here.
    """
    c = int(chunk_words)
    if c < 1 or (c & (c - 1)) or c > 128:
        raise ValueError(
            f"chunk_words={chunk_words!r} must be a power of two in "
            "[1, 128]")
    n_words = max((n + WORD_BITS - 1) // WORD_BITS, 1)
    n_chunks = (n_words + c - 1) // c
    sw = (n_chunks + WORD_BITS - 1) // WORD_BITS
    cols = np.asarray(indices, dtype=np.int64)
    deg = np.asarray(indptr[1:], np.int64) - np.asarray(indptr[:-1],
                                                        np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    chunk_of = cols // (WORD_BITS * c)
    # CSR rows are sorted, so (row, chunk) keys arrive sorted; unique
    # gives the stored-chunk list in row-major / ascending-chunk order.
    key = rows * n_chunks + chunk_of
    uniq, inv = np.unique(key, return_inverse=True)
    stored_row = (uniq // n_chunks).astype(np.int64)
    stored_chunk = (uniq % n_chunks).astype(np.int64)
    counts = np.bincount(stored_row, minlength=n)[:n]
    kmax = max(int(counts.max(initial=1)), 1)
    chunk_ptr = np.zeros(n + 1, dtype=np.int32)
    chunk_ptr[1:] = np.cumsum(counts)
    chunk_id = np.zeros(len(uniq) + kmax, dtype=np.int32)
    chunk_id[:len(uniq)] = stored_chunk
    chunk_data = np.zeros((len(uniq) + kmax, c), dtype=np.uint32)
    if cols.size:
        np.bitwise_or.at(
            chunk_data, (inv, (cols // WORD_BITS) % c),
            np.uint32(1) << (cols % WORD_BITS).astype(np.uint32))
    summary = np.zeros((n, sw), dtype=np.uint32)
    if len(uniq):
        np.bitwise_or.at(
            summary, (stored_row, stored_chunk // WORD_BITS),
            np.uint32(1) << (stored_chunk % WORD_BITS).astype(np.uint32))
    return HierBitmap(summary=summary, chunk_ptr=chunk_ptr,
                      chunk_id=chunk_id, chunk_data=chunk_data,
                      chunk_words=c, n_chunks=int(n_chunks), kmax=kmax)


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
        object.__setattr__(self, "_hier", {})
        object.__setattr__(self, "_label_index", None)
        object.__setattr__(self, "_nlf_counts", None)

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

    def hier_bitmap(self, chunk_words: int = 8) -> HierBitmap:
        """Two-level adjacency view (cached per chunk width) — the
        summary bitmap is built alongside the chunk store in one O(E)
        pass, see :func:`build_hier_bitmap`."""
        key = int(chunk_words)
        if key not in self._hier:
            self._hier[key] = build_hier_bitmap(
                self.n, self.indptr, self.indices, chunk_words=key)
        return self._hier[key]

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
        """[n, n_labels] int32 — count of each label among neighbors.
        Built on first use and kept (read-only)."""
        if self._nlf_counts is None:
            counts = np.zeros((self.n, self.n_labels), dtype=np.int32)
            src = np.repeat(np.arange(self.n, dtype=np.int32), self.degrees)
            np.add.at(counts, (src, self.labels[self.indices]), 1)
            counts.flags.writeable = False
            object.__setattr__(self, "_nlf_counts", counts)
        return self._nlf_counts

    def relabel(self, order: np.ndarray) -> "Graph":
        """A copy with vertex ``order[i]`` renamed to ``i`` (``order``
        must be a permutation of 0..n-1)."""
        order = np.asarray(order, dtype=np.int64)
        inv = np.empty(self.n, dtype=np.int32)
        inv[order] = np.arange(self.n, dtype=np.int32)
        src = inv[np.repeat(np.arange(self.n, dtype=np.int64),
                            self.degrees.astype(np.int64))]
        dst = inv[self.indices]
        perm = np.lexsort((dst, src))
        indptr = np.zeros(self.n + 1, dtype=np.int32)
        indptr[1:] = np.cumsum(np.bincount(src, minlength=self.n))
        return Graph(n=self.n, labels=self.labels[order].copy(),
                     indptr=indptr, indices=dst[perm].astype(np.int32),
                     n_labels=self.n_labels)


def degree_descending_order(g: Graph) -> np.ndarray:
    """Vertex order that concentrates the hierarchical layout: hubs get
    the low ids (stable degree-descending sort), so every row's neighbor
    bits cluster in the low chunks and the summary intersection marks
    fewer chunks live. Apply with ``g.relabel(order)``; ``order[new] ==
    old`` maps embeddings over the relabeled graph back."""
    return np.argsort(-g.degrees.astype(np.int64), kind="stable")
