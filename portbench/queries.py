"""The query pool: the paper's random-walk protocol, frozen.

A query of ``k`` vertices is the subgraph induced on the first ``k``
distinct data vertices a random walk visits from a uniform start (paper
section 5; the pattern is ``repro_torch.data.graph_gen.random_walk_query``).
Labels are inherited. The pool of a run is drawn from ``--seed`` alone,
so the same seed gives the same queries in the same order.
"""
from __future__ import annotations

import numpy as np

from .reference.match import DataGraph, Query


def random_walk_query(g: DataGraph, k: int, rng: np.random.Generator,
                      max_tries: int = 200) -> Query:
    for _ in range(max_tries):
        cur = int(rng.integers(0, g.n))
        seen = {cur: 0}
        steps = 0
        while len(seen) < k and steps < 50 * k:
            nb = g.neighbors(cur)
            steps += 1
            if nb.size == 0:
                break
            cur = int(nb[rng.integers(0, nb.size)])
            seen.setdefault(cur, len(seen))
        if len(seen) == k:
            verts = np.array(sorted(seen), np.int64)
            a, b = np.meshgrid(verts, verts, indexing="ij")
            upper = a < b
            a, b = a[upper], b[upper]
            hit = g.has_edges(a, b)
            remap = {v: i for i, v in enumerate(verts.tolist())}
            edges = np.array([[remap[x], remap[y]] for x, y in
                              zip(a[hit].tolist(), b[hit].tolist())],
                             np.int64).reshape(-1, 2)
            return Query(labels=g.labels[verts].astype(np.int32),
                         edges=edges)
    raise RuntimeError("could not extract a connected query")


def query_pool(g: DataGraph, k: int, size: int, seed: int) -> list[Query]:
    """``size`` queries of ``k`` vertices from ``seed``."""
    rng = np.random.default_rng([int(seed), k])
    return [random_walk_query(g, k, rng) for _ in range(size)]
