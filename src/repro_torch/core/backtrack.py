"""Faithful sequential subgraph matching (paper Algorithms 1 and 2).

Semantics: non-induced subgraph isomorphism (monomorphism) — Definition 1:
label constraint, edge constraint (query edges must map to data edges),
injection constraint.

Two entry points:

* :func:`backtrack_naive`   — Algorithm 1 (plain backtracking).
* :func:`backtrack_deadend` — Algorithm 2 (dead-end pattern pruning), with
  ``use_pruning=False`` reproducing the paper's "No pruning" ablation
  (identical code path minus the match/prune lines 14–15).

Candidate refinement (Eq. 2) is performed incrementally: mapping
``order[d] -> v`` intersects the candidate sets of unmapped query
neighbors with ``N(v)``; undone on backtrack. The child call performs the
empty-candidate check (line 7), so recursion counts match the paper's
accounting (refinement is conceptually inside the callee).

All indices inside the search are *order positions* (depth in the matching
order), not original query-vertex ids; reported embeddings are converted
back to query-vertex indexing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from .candidates import build_candidates
from .deadend import NumericDeadEndTable, SetDeadEndTable
from .graph import Graph
from .ordering import connected_min_candidate_order

DEFAULT_LIMIT = 1000


@dataclasses.dataclass
class SearchStats:
    recursions: int = 0
    found: int = 0
    deadend_prunes: int = 0
    injectivity_fails: int = 0
    empty_candidate_fails: int = 0
    aborted: bool = False
    # why the search stopped early: None (ran to completion), "limit"
    # (result cap reached), "recursions"/"rows" (recursion budget),
    # "time" (wall-clock budget), or "cancelled" (evicted by
    # MatchHandle.cancel). Serving layers map this to a status.
    abort_reason: str | None = None
    wall_time_s: float = 0.0
    # time from search start to the first emitted embedding (None when
    # nothing was found) — the serving layer's TTFE metric
    ttfe_s: float | None = None
    table_stats: object | None = None


@dataclasses.dataclass
class MatchResult:
    embeddings: list[np.ndarray]  # each [n_query] data-vertex per query id
    stats: SearchStats


def _prepare(query: Graph, data: Graph, cand, order):
    if cand is None:
        cand = build_candidates(query, data)
    if order is None:
        order = connected_min_candidate_order(query, cand)
    order = np.asarray(order, dtype=np.int32)
    n = query.n
    # position-indexed views
    pos_of = np.empty(n, dtype=np.int32)
    pos_of[order] = np.arange(n, dtype=np.int32)
    # mapped-neighbor positions: for position d, positions p<d adjacent in Q
    nbr_pos: list[np.ndarray] = []
    for d in range(n):
        q = int(order[d])
        ps = np.sort(pos_of[query.neighbors(q)])
        nbr_pos.append(ps.astype(np.int32))
    cand_by_pos = [np.asarray(cand[int(order[d])], dtype=np.int32)
                   for d in range(n)]
    return cand_by_pos, order, pos_of, nbr_pos


def backtrack_naive(query: Graph, data: Graph,
                    cand: list[np.ndarray] | None = None,
                    order: np.ndarray | None = None,
                    limit: int | None = DEFAULT_LIMIT,
                    max_recursions: int | None = None,
                    time_budget_s: float | None = None) -> MatchResult:
    """Algorithm 1: plain backtracking with Eq. 2 refinement."""
    t0 = time.perf_counter()
    cand_by_pos, order, pos_of, nbr_pos = _prepare(query, data, cand, order)
    n = query.n
    nbr_sorted = data.neighbor_sorted
    stats = SearchStats()
    embeddings: list[np.ndarray] = []
    mapping = np.full(n, -1, dtype=np.int32)
    used = np.zeros(data.n, dtype=bool)
    cur = list(cand_by_pos)  # candidate arrays per position, refined in place

    def search(depth: int) -> None:
        stats.recursions += 1
        if stats.aborted:
            return
        if max_recursions is not None and stats.recursions > max_recursions:
            stats.aborted = True
            stats.abort_reason = "recursions"
            return
        if time_budget_s is not None and stats.recursions % 4096 == 0 \
                and time.perf_counter() - t0 > time_budget_s:
            stats.aborted = True
            stats.abort_reason = "time"
            return
        if depth == n:
            emb = np.empty(n, dtype=np.int32)
            emb[order] = mapping
            embeddings.append(emb)
            stats.found += 1
            if limit is not None and stats.found >= limit:
                stats.aborted = True
                stats.abort_reason = "limit"
            return
        # line 7 empty-candidate check over unmapped positions
        for d in range(depth, n):
            if len(cur[d]) == 0:
                stats.empty_candidate_fails += 1
                return
        for v in cur[depth]:
            v = int(v)
            if used[v]:
                stats.injectivity_fails += 1
                continue
            # Eq. 2 incremental refinement for unmapped neighbors of depth
            saved: list[tuple[int, np.ndarray]] = []
            nv = nbr_sorted[v]
            for p in nbr_pos[depth]:
                p = int(p)
                if p > depth:
                    saved.append((p, cur[p]))
                    cur[p] = np.intersect1d(cur[p], nv, assume_unique=True)
            mapping[depth] = v
            used[v] = True
            search(depth + 1)
            used[v] = False
            mapping[depth] = -1
            for p, arr in saved:
                cur[p] = arr
            if stats.aborted:
                return

    search(0)
    stats.wall_time_s = time.perf_counter() - t0
    return MatchResult(embeddings, stats)


def backtrack_deadend(query: Graph, data: Graph,
                      cand: list[np.ndarray] | None = None,
                      order: np.ndarray | None = None,
                      limit: int | None = DEFAULT_LIMIT,
                      max_recursions: int | None = None,
                      time_budget_s: float | None = None,
                      table_cls: Callable = NumericDeadEndTable,
                      use_pruning: bool = True,
                      on_embedding: Callable | None = None,
                      should_abort: Callable | None = None) -> MatchResult:
    """Algorithm 2: backtracking with dead-end pattern learning + pruning.

    ``use_pruning=False`` keeps pattern extraction/recording but skips the
    match/prune step (the paper's 'No pruning' comparison, §5.2).
    ``table_cls`` selects the numeric (paper, O(1)) or set-based
    (reference-semantics) table.

    ``on_embedding`` — called with each embedding (int32 [n_query]) as
    it is found, before the search continues: the sequential backend's
    incremental-delivery hook for ``MatchHandle.stream()``.
    ``should_abort`` — polled at every embedding and periodically
    between recursions; returning True stops the search with
    ``abort_reason == "cancelled"`` (partial results are kept).
    """
    t0 = time.perf_counter()
    cand_by_pos, order, pos_of, nbr_pos = _prepare(query, data, cand, order)
    n = query.n
    nbr_sorted = data.neighbor_sorted
    stats = SearchStats()
    table = table_cls(n)
    stats.table_stats = table.stats
    embeddings: list[np.ndarray] = []
    mapping_arr = np.full(n, -1, dtype=np.int32)
    mapping: list[int] = []          # data vertices by position (stack)
    used = np.zeros(data.n, dtype=bool)
    inv = np.full(data.n, -1, dtype=np.int32)  # data vertex -> position
    cur = list(cand_by_pos)
    phi = np.zeros(n + 1, dtype=np.int64)      # Φ[i] = id of length-i prefix

    def search(depth: int):
        """Returns None if the subtree reported (or was aborted); else the
        dead-end mask of the current partial embedding, as a frozenset of
        order positions < depth."""
        stats.recursions += 1
        phi[depth] = stats.recursions
        if max_recursions is not None and stats.recursions > max_recursions:
            stats.aborted = True
            stats.abort_reason = "recursions"
            return None
        if time_budget_s is not None and stats.recursions % 4096 == 0 \
                and time.perf_counter() - t0 > time_budget_s:
            stats.aborted = True
            stats.abort_reason = "time"
            return None
        if should_abort is not None and stats.recursions % 1024 == 0 \
                and should_abort():
            stats.aborted = True
            stats.abort_reason = "cancelled"
            return None
        if depth == n:
            emb = np.empty(n, dtype=np.int32)
            emb[order] = mapping_arr
            embeddings.append(emb)
            stats.found += 1
            if stats.ttfe_s is None:
                stats.ttfe_s = time.perf_counter() - t0
            if on_embedding is not None:
                on_embedding(emb)
            if limit is not None and stats.found >= limit:
                stats.aborted = True
                stats.abort_reason = "limit"
            elif should_abort is not None and should_abort():
                stats.aborted = True
                stats.abort_reason = "cancelled"
            return None
        # ---- Case 1: empty candidate set (Lemma 1) ----------------------
        for d in range(depth, n):
            if len(cur[d]) == 0:
                stats.empty_candidate_fails += 1
                gamma = frozenset(int(p) for p in nbr_pos[d] if p < depth)
                _record(depth, gamma)
                return gamma
        gamma_star: set[int] = set()
        reported = False
        for v in cur[depth]:
            v = int(v)
            if used[v]:
                # ---- Case 2: injectivity (Lemma 2) ----------------------
                stats.injectivity_fails += 1
                gamma_star.add(int(inv[v]))
                gamma_star.add(depth)
                continue
            if use_pruning:
                hit = table.match(depth, v, mapping, phi)
                if hit is not None:
                    # ---- Case 3: dead-end pattern (Lemma 3) -------------
                    stats.deadend_prunes += 1
                    gamma_star |= set(hit)
                    gamma_star.add(depth)
                    continue
            # ---- Case 4: recurse ----------------------------------------
            saved: list[tuple[int, np.ndarray]] = []
            nv = nbr_sorted[v]
            for p in nbr_pos[depth]:
                p = int(p)
                if p > depth:
                    saved.append((p, cur[p]))
                    cur[p] = np.intersect1d(cur[p], nv, assume_unique=True)
            mapping_arr[depth] = v
            mapping.append(v)
            used[v] = True
            inv[v] = depth
            child = search(depth + 1)
            used[v] = False
            inv[v] = -1
            mapping.pop()
            mapping_arr[depth] = -1
            for p, arr in saved:
                cur[p] = arr
            if stats.aborted:
                return None
            if child is None:
                reported = True
            else:
                gamma_star |= child
        if reported:
            return None
        # ---- Lemma 4 / Eq. 5 conversion ---------------------------------
        if depth in gamma_star:
            gamma = (gamma_star |
                     {int(p) for p in nbr_pos[depth]})
            gamma = frozenset(p for p in gamma if p < depth)
        else:
            gamma = frozenset(gamma_star)
        _record(depth, gamma)
        return gamma

    def _record(depth: int, gamma: frozenset[int]) -> None:
        # line 19-20: record the pattern keyed by the last mapping
        if depth == 0 or stats.aborted:
            return
        table.store(depth - 1, mapping[depth - 1], mapping, gamma, phi)

    search(0)
    stats.wall_time_s = time.perf_counter() - t0
    return MatchResult(embeddings, stats)
