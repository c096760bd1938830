"""Synthetic graph datasets and query workloads.

The paper evaluates on the yeast (3112 V / 12519 E / 71 labels) and human
(4674 V / 86282 E / 44 labels) protein-interaction graphs, with query
graphs extracted as random-walk connected subgraphs and query sets of many
queries per size. Those datasets are not redistributable offline, so we
generate synthetic graphs with matched vertex/edge/label statistics and a
heavy-tailed degree profile (preferential attachment + extra random
edges), plus the paper's exact query-extraction protocol.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import Graph, degree_descending_order


def _zipf_labels(rng: np.random.Generator, n: int, n_labels: int,
                 s: float = 1.1) -> np.ndarray:
    """Zipf-ish label distribution — a few frequent labels, a long tail,
    which is what makes label filters weak and the paper's pruning shine."""
    w = 1.0 / np.arange(1, n_labels + 1) ** s
    w /= w.sum()
    labels = rng.choice(n_labels, size=n, p=w)
    # guarantee every label appears at least once (keeps |Sigma| honest)
    labels[:n_labels] = np.arange(n_labels)
    return labels.astype(np.int32)


def ba_labeled_graph(n: int, m_attach: int, n_labels: int,
                     extra_edges: int = 0, seed: int = 0) -> Graph:
    """Barabasi-Albert preferential attachment + optional random edges."""
    rng = np.random.default_rng(seed)
    edges: list[tuple[int, int]] = []
    targets = list(range(min(m_attach, n)))
    repeated: list[int] = list(targets)
    for v in range(m_attach, n):
        chosen = rng.choice(repeated, size=min(m_attach, len(repeated)),
                            replace=False)
        for t in set(int(c) for c in chosen):
            edges.append((v, t))
            repeated.append(t)
        repeated.extend([v] * m_attach)
    for _ in range(extra_edges):
        a, b = rng.integers(0, n, size=2)
        if a != b:
            edges.append((int(a), int(b)))
    labels = _zipf_labels(rng, n, n_labels)
    return Graph.from_edges(n, edges, labels, n_labels)


def powerlaw_graph(n: int, m_attach: int = 3, n_labels: int = 16,
                   seed: int = 0, degree_sorted: bool = True) -> Graph:
    """BA-style labeled power-law graph, vectorized for large ``n``.

    ``ba_labeled_graph`` keeps a growing Python list of repeated
    endpoints and draws with ``rng.choice`` over it per vertex — fine at
    512 vertices, minutes at 64K. Here the endpoint pool is a
    preallocated array (each vertex appends at most ``2 * m_attach``
    entries) and each step draws ``m_attach`` uniform *indices* into the
    filled prefix, which is exactly degree-proportional sampling; the
    per-vertex work is a handful of O(m) numpy ops, so 64K vertices
    build in seconds.

    ``degree_sorted=True`` relabels the result in degree-descending
    order — the locality transform the hierarchical adjacency layout
    (core.graph.HierBitmap) wants: hubs take the low vertex ids, so
    every row's neighbor bits concentrate in the low chunks, stored
    chunk counts stay small and the summary intersection kills more of
    the chunk walk.
    """
    rng = np.random.default_rng(seed)
    if n <= 1:
        return Graph.from_edges(n, [], _zipf_labels(rng, max(n, 1),
                                                    n_labels)[:n], n_labels)
    m = int(max(1, min(m_attach, n - 1)))
    if n <= m + 1:                     # degenerate tiny graph: clique
        edges = [(a, b) for a in range(n) for b in range(a)]
        return Graph.from_edges(n, edges, _zipf_labels(rng, n, n_labels),
                                n_labels)
    src = np.empty(m * n, np.int64)
    dst = np.empty(m * n, np.int64)
    pool = np.empty(2 * m * n, np.int64)
    ne = ps = 0
    # seed: vertex m attaches to every earlier vertex once
    src[:m] = m
    dst[:m] = np.arange(m)
    pool[:m] = m
    pool[m:2 * m] = np.arange(m)
    ne = m
    ps = 2 * m
    for v in range(m + 1, n):
        targets = np.unique(pool[rng.integers(0, ps, size=m)])
        k = targets.size
        src[ne:ne + k] = v
        dst[ne:ne + k] = targets
        ne += k
        pool[ps:ps + k] = targets
        pool[ps + k:ps + k + m] = v
        ps += k + m
    edges = list(zip(src[:ne].tolist(), dst[:ne].tolist()))
    labels = _zipf_labels(rng, n, n_labels)
    g = Graph.from_edges(n, edges, labels, n_labels)
    if degree_sorted:
        g = g.relabel(degree_descending_order(g))
    return g


def er_labeled_graph(n: int, n_edges: int, n_labels: int,
                     seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    edges = set()
    while len(edges) < n_edges:
        a, b = rng.integers(0, n, size=2)
        if a != b:
            edges.add((min(int(a), int(b)), max(int(a), int(b))))
    labels = _zipf_labels(rng, n, n_labels)
    return Graph.from_edges(n, list(edges), labels, n_labels)


def yeast_like_graph(seed: int = 0) -> Graph:
    """|V|=3112, |E|~12519, 71 labels — matches the paper's yeast stats."""
    n, target_e, n_labels = 3112, 12519, 71
    g = ba_labeled_graph(n, 3, n_labels,
                         extra_edges=max(0, target_e - 3 * n), seed=seed)
    return g


def human_like_graph(seed: int = 0) -> Graph:
    """|V|=4674, |E|~86282, 44 labels — matches the paper's human stats.

    Much denser (avg degree ~37): the regime where structural filters are
    weak and search-failure learning matters most.
    """
    n, target_e, n_labels = 4674, 86282, 44
    m = 9  # ~ BA backbone
    g = ba_labeled_graph(n, m, n_labels,
                         extra_edges=max(0, target_e - m * n), seed=seed)
    return g


def random_walk_query(data: Graph, n_vertices: int,
                      seed: int = 0, max_tries: int = 200) -> Graph:
    """Extract a connected query subgraph by random walk (paper §5).

    Walks the data graph collecting vertices until ``n_vertices`` distinct
    ones are visited, then takes the *induced* subgraph on them (so the
    query always has at least ``n_vertices - 1`` edges and realistic label
    correlations). Vertex labels are inherited.
    """
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        start = int(rng.integers(0, data.n))
        visited: list[int] = [start]
        vset = {start}
        cur = start
        steps = 0
        while len(vset) < n_vertices and steps < 50 * n_vertices:
            nbrs = data.neighbors(cur)
            steps += 1
            if len(nbrs) == 0:
                break
            cur = int(nbrs[rng.integers(0, len(nbrs))])
            if cur not in vset:
                vset.add(cur)
                visited.append(cur)
        if len(vset) == n_vertices:
            verts = sorted(vset)
            remap = {v: i for i, v in enumerate(verts)}
            edges = [(remap[a], remap[int(b)]) for a in verts
                     for b in data.neighbors(a) if int(b) in vset and a < b]
            labels = [int(data.labels[v]) for v in verts]
            return Graph.from_edges(n_vertices, edges, labels, data.n_labels)
    raise RuntimeError("could not extract a connected query")


def query_set(data: Graph, n_vertices: int, n_queries: int,
              seed: int = 0) -> list[Graph]:
    return [random_walk_query(data, n_vertices, seed=seed * 100003 + i)
            for i in range(n_queries)]


def trap_graph(n_b: int = 30, n_c: int = 30, n_good: int = 2,
               tail_len: int = 2, seed: int = 0
               ) -> tuple[Graph, Graph]:
    """Scaled version of the paper's Fig. 1 hard case.

    Query: path  a - b - c - a - (tail of d's...), labels a,b,c,a,d,d,...
    Data:  one hub 'a' vertex v0 (which also carries a d-tail, so it stays
    arc-consistent as a candidate for the *second* 'a'); ``n_b`` 'b'
    vertices all adjacent to v0; each 'b' adjacent to all ``n_c`` 'c'
    vertices. Every 'c' has an 'a' neighbor: for the ``n_good`` good ones
    it is a fresh 'a' vertex with its own d-tail; for the bad ones it is
    *v0 itself* (the paper's v6/v7 situation).

    A partial embedding u1->v0, u2->b_i, u3->bad c_j then fails only at
    the injectivity check (u4 would reuse v0) — a failure invisible to
    label/degree/neighbor-label filters AND to arc-consistency, repeated
    ``n_b x n_c`` times by plain backtracking but learned once per c_j by
    dead-end pruning as the pattern {(u1,v0),(u3,c_j)} (exactly the
    paper's {(u1,v1),(u3,v6)} example). Expected recursions:
    Theta(n_b * n_c) without pruning vs Theta(n_b + n_c) with pruning.

    Returns (query, data).
    """
    # labels: a=0, b=1, c=2, d=3
    q_edges = [(0, 1), (1, 2), (2, 3)]
    q_labels = [0, 1, 2, 0]
    for t in range(tail_len):
        q_edges.append((3 + t, 4 + t))
        q_labels.append(3)
    query = Graph.from_edges(4 + tail_len, q_edges, q_labels, 4)

    rng = np.random.default_rng(seed)
    edges: list[tuple[int, int]] = []
    labels: list[int] = [0]                      # v0: the hub 'a'
    b_ids = list(range(1, 1 + n_b))
    labels += [1] * n_b
    c_ids = list(range(1 + n_b, 1 + n_b + n_c))
    labels += [2] * n_c
    nxt = 1 + n_b + n_c

    def add_tail(root: int) -> None:
        nonlocal nxt
        prev = root
        for _ in range(tail_len):
            d = nxt; nxt += 1
            labels.append(3)
            edges.append((prev, d))
            prev = d

    for b in b_ids:
        edges.append((0, b))
        for c in c_ids:
            edges.append((b, c))
    good = set(int(g) for g in rng.choice(n_c, size=n_good, replace=False))
    for ci, c in enumerate(c_ids):
        if ci in good:
            a2 = nxt; nxt += 1
            labels.append(0)
            edges.append((c, a2))
            add_tail(a2)
        else:
            edges.append((c, 0))      # bad c: its only 'a' neighbor is v0
    add_tail(0)                       # keep v0 arc-consistent for u4
    data = Graph.from_edges(nxt, edges, labels, 4)
    return query, data


def corridor_graph(n_bait: int = 64, n_spines: int = 2, seed: int = 0
                   ) -> tuple[Graph, Graph]:
    """Repeated-template workload: prefix-independent dead-end corridors.

    Query: a 7-vertex path with distinct labels 0-1-2-3-4-5-6.
    Data: one root r (label 0) on a real spine r-s1-...-s6 (labels 1..6),
    plus ``n_bait`` *bait corridors*: chains b1-b2-b3-b4-b5 (labels 1..5)
    with b1 attached to r and the chain cut before label 6. Every bait
    passes the label/degree/NLF filters and survives the bounded
    CFL-lite refinement (the emptiness needs 4 propagation hops, one
    more than its round budget), so the search must discover each
    corridor's death by descending into it — and the failure depends
    *only* on (position 1, b1): the learned Lemma-1 patterns all have
    μ == 0.

    That makes this the showcase for cross-query pattern reuse: within
    one run each bait is entered exactly once (learning can't help —
    there is a single root), so the cold prune rate is ~0, while a
    warm-started rerun of the same template prunes all ``n_bait`` baits
    at the first extraction. ``trap_graph`` is the opposite pin: all its
    patterns are μ == 1 and intra-query learning is what matters.
    ``n_spines`` (>= 2) real spines carry the true embeddings.

    Returns (query, data).
    """
    del seed                          # deterministic by construction
    n = 7
    q_edges = [(i, i + 1) for i in range(n - 1)]
    query = Graph.from_edges(n, q_edges, list(range(n)), n)

    edges: list[tuple[int, int]] = []
    labels: list[int] = [0]           # vertex 0: the root r
    nxt = 1
    # >= 2 real spines keep every non-root candidate set larger than
    # C[u0] = {r}, so the rarity-first ordering starts at the root and
    # walks the path — the schedule that actually enters the corridors
    for _ in range(max(2, n_spines)):     # real spines s1..s6
        spine_prev = 0
        for lab in range(1, 7):
            edges.append((spine_prev, nxt))
            labels.append(lab)
            spine_prev = nxt
            nxt += 1
    for _ in range(n_bait):           # bait corridors b1..b5
        prev = 0
        for lab in range(1, 6):
            edges.append((prev, nxt))
            labels.append(lab)
            prev = nxt
            nxt += 1
    data = Graph.from_edges(nxt, edges, labels, n)
    return query, data
