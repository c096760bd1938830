"""The plain reference of subgraph matching, in NumPy.

Semantics (paper Definition 1): non-induced subgraph isomorphism. A row
``emb`` maps query vertex ``u`` to data vertex ``emb[u]``; it is an
embedding when every label agrees, every query edge lands on a data
edge and no data vertex is used twice. A query at limit ``L`` is
answered by ``min(total, L)`` distinct embeddings.

Nothing here imports the program: the data graph and the queries come
from the benchmark's own inputs (CSR arrays, label arrays, edge lists),
and the search is a plain backtracking written for this file alone.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataGraph:
    n: int
    labels: np.ndarray     # int32 [n]
    indptr: np.ndarray     # int64 [n + 1]
    indices: np.ndarray    # int64 [2E], each row sorted
    keys: np.ndarray       # int64 [2E] sorted: row * n + column

    @staticmethod
    def of(arrays: dict) -> "DataGraph":
        n = int(arrays["n"])
        indptr = np.asarray(arrays["indptr"], np.int64)
        indices = np.asarray(arrays["indices"], np.int64)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        return DataGraph(n=n, labels=np.asarray(arrays["labels"], np.int32),
                         indptr=indptr, indices=indices,
                         keys=rows * n + indices)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def has_edges(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Elementwise: is ``(a[i], b[i])`` an edge?"""
        key = np.asarray(a, np.int64) * self.n + np.asarray(b, np.int64)
        i = np.searchsorted(self.keys, key)
        i = np.minimum(i, self.keys.size - 1)
        return self.keys[i] == key


@dataclasses.dataclass(frozen=True)
class Query:
    labels: np.ndarray     # int32 [k]
    edges: np.ndarray      # int64 [e, 2], a < b

    @property
    def k(self) -> int:
        return int(self.labels.size)

    def neighbors(self, u: int) -> set[int]:
        e = self.edges
        return set(e[e[:, 0] == u, 1].tolist()) | set(
            e[e[:, 1] == u, 0].tolist())


def matching_order(q: Query, cand: list[np.ndarray]) -> list[int]:
    """Fewest candidates first; then, among vertices joined to those
    placed, the one with most placed neighbours, then fewest
    candidates, then the lowest id."""
    nbrs = [q.neighbors(u) for u in range(q.k)]
    order = [min(range(q.k), key=lambda u: (cand[u].size, u))]
    placed = set(order)
    while len(order) < q.k:
        front = [u for u in range(q.k) if u not in placed
                 and nbrs[u] & placed] or [u for u in range(q.k)
                                           if u not in placed]
        u = min(front, key=lambda u: (-len(nbrs[u] & placed),
                                      cand[u].size, u))
        order.append(u)
        placed.add(u)
    return order


def enumerate_embeddings(q: Query, g: DataGraph, limit: int | None,
                         keep: bool = False, parent_edge_only: bool = False
                         ) -> tuple[int, list[np.ndarray]]:
    """``(count, rows)``: up to ``limit`` embeddings of ``q`` in ``g``
    by backtracking (rows kept only with ``keep``).

    ``parent_edge_only`` is the benchmark's control: it checks only the
    edge to the first placed neighbour of each query vertex and leaves
    the query's other edges unchecked, the shortcut of refining against
    a spanning tree. It breaks the edge guarantee, and the comparison
    has to see that."""
    qdeg = np.zeros(q.k, np.int64)
    np.add.at(qdeg, q.edges.reshape(-1), 1)
    gdeg = g.degrees
    cand_mask = [(g.labels == q.labels[u]) & (gdeg >= qdeg[u])
                 for u in range(q.k)]
    cand = [np.flatnonzero(m) for m in cand_mask]
    order = matching_order(q, cand)
    pos = {u: d for d, u in enumerate(order)}
    nbrs = [q.neighbors(u) for u in range(q.k)]
    back = [sorted(pos[w] for w in nbrs[u] if pos[w] < d)
            for d, u in enumerate(order)]
    if parent_edge_only:
        back = [b[:1] for b in back]
    mapped = np.full(q.k, -1, np.int64)       # by position
    used = np.zeros(g.n, bool)
    rows: list[np.ndarray] = []
    count = 0

    def search(d: int) -> bool:
        nonlocal count
        if d == q.k:
            count += 1
            if keep:
                row = np.empty(q.k, np.int64)
                row[order] = mapped
                rows.append(row)
            return limit is not None and count >= limit
        u = order[d]
        if back[d]:
            c = g.neighbors(int(mapped[back[d][0]]))
            c = c[cand_mask[u][c]]
            for p in back[d][1:]:
                c = c[g.has_edges(np.full(c.size, mapped[p]), c)]
        else:
            c = cand[u]
        c = c[~used[c]]
        for v in c.tolist():
            mapped[d] = v
            used[v] = True
            stop = search(d + 1)
            used[v] = False
            if stop:
                return True
        mapped[d] = -1
        return False

    if all(c.size for c in cand):
        search(0)
    return count, rows


def row_faults(q: Query, g: DataGraph, emb: np.ndarray
               ) -> tuple[int, int]:
    """``(invalid, duplicate)`` rows of ``emb`` [m, k]: a row is invalid
    when a vertex is out of range, a label differs, a query edge misses
    or a data vertex repeats; duplicate rows are counted past the
    first."""
    emb = np.asarray(emb, np.int64).reshape(-1, q.k)
    if emb.shape[0] == 0:
        return 0, 0
    bad = ((emb < 0) | (emb >= g.n)).any(axis=1)
    safe = np.where(bad[:, None], 0, emb)
    bad |= (g.labels[safe] != q.labels[None, :]).any(axis=1)
    for a, b in q.edges.tolist():
        bad |= ~g.has_edges(safe[:, a], safe[:, b])
    s = np.sort(safe, axis=1)
    bad |= (s[:, 1:] == s[:, :-1]).any(axis=1)
    dup = emb.shape[0] - np.unique(emb, axis=0).shape[0]
    return int(bad.sum()), int(dup)
