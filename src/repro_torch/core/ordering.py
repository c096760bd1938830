"""Matching-order selection.

The backtracking maps query vertices in a fixed order ``u_1, ..., u_n``.
Requirements and heuristics (mirrors the QuickSI / CFL-Match lineage the
paper builds on):

* connectivity — every prefix must induce a connected subgraph of the
  query (VF2 invariant), so Eq. 2 always constrains the next vertex;
* rarity first — start from the query vertex with the fewest candidates
  (QuickSI's rare-label heuristic, generalized to candidate counts);
* greedy min-candidate expansion — among vertices adjacent to the chosen
  prefix, pick the one with the smallest candidate set, tie-broken by
  higher query degree (more constraints earlier).
"""
from __future__ import annotations

import numpy as np

from .graph import Graph


def connected_min_candidate_order(query: Graph,
                                  cand: list[np.ndarray]) -> np.ndarray:
    """Return a permutation of query vertices (the matching order)."""
    n = query.n
    sizes = np.array([len(c) for c in cand], dtype=np.int64)
    degrees = query.degrees
    # start: fewest candidates; tie-break by high degree then id
    start = min(range(n), key=lambda u: (sizes[u], -degrees[u], u))
    order = [start]
    in_order = np.zeros(n, dtype=bool)
    in_order[start] = True
    frontier = set(int(w) for w in query.neighbors(start))
    for _ in range(n - 1):
        frontier = {u for u in frontier if not in_order[u]}
        if frontier:
            # prefer many already-ordered neighbors (tighter Eq. 2), then
            # fewer candidates, then higher degree
            def key(u: int):
                back = sum(1 for w in query.neighbors(u) if in_order[w])
                return (-back, sizes[u], -degrees[u], u)
            nxt = min(frontier, key=key)
        else:  # disconnected query: jump to rarest unvisited vertex
            nxt = min((u for u in range(n) if not in_order[u]),
                      key=lambda u: (sizes[u], -degrees[u], u))
        order.append(nxt)
        in_order[nxt] = True
        frontier |= {int(w) for w in query.neighbors(nxt)}
    return np.asarray(order, dtype=np.int32)
