"""The plain reference against brute-force enumeration, against the
port's sequential oracle, and its fault counting; the control fails."""
import itertools
import subprocess
import sys

import numpy as np
import pytest

from portbench.datasets.cache import to_csr
from portbench.reference.match import (DataGraph, Query,
                                       enumerate_embeddings, row_faults)
from portbench.tests.tiny import REPO


def small_graph(rng, n, p, n_labels):
    a, b = np.triu_indices(n, 1)
    keep = rng.random(a.size) < p
    indptr, indices = to_csr(n, a[keep], b[keep])
    return DataGraph.of({"n": n, "labels": rng.integers(0, n_labels, n),
                         "indptr": indptr, "indices": indices})


def small_query(rng, g, k):
    from portbench.queries import random_walk_query
    return random_walk_query(g, k, rng)


def brute(q, g):
    out = set()
    for perm in itertools.permutations(range(g.n), q.k):
        e = np.array(perm)
        if (g.labels[e] != q.labels).any():
            continue
        if all(g.has_edges(np.array([e[a]]), np.array([e[b]]))[0]
               for a, b in q.edges.tolist()):
            out.add(perm)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_reference_equals_brute_force(seed):
    rng = np.random.default_rng(seed)
    g = small_graph(rng, 9, 0.45, 2)
    q = small_query(rng, g, 3 + seed % 2)
    want = brute(q, g)
    n, rows = enumerate_embeddings(q, g, None, keep=True)
    assert n == len(want)
    assert {tuple(r.tolist()) for r in rows} == want
    assert row_faults(q, g, np.array(rows).reshape(-1, q.k)) == (0, 0)
    lim = max(1, len(want) // 2)
    m, part = enumerate_embeddings(q, g, lim, keep=True)
    assert m == min(lim, len(want))
    assert {tuple(r.tolist()) for r in part} <= want


def test_reference_counts_equal_the_ports_sequential_oracle():
    from repro_torch.core.backtrack import backtrack_deadend
    from repro_torch.core.graph import Graph
    from portbench.queries import query_pool
    rng = np.random.default_rng(7)
    g = small_graph(rng, 120, 0.08, 4)
    data = Graph(n=g.n, labels=g.labels, indptr=g.indptr.astype(np.int32),
                 indices=g.indices.astype(np.int32), n_labels=4)
    for q in query_pool(g, 5, 12, seed=2**31 + 11):
        pq = Graph.from_edges(q.k, [tuple(e) for e in q.edges.tolist()],
                              q.labels, 4)
        for limit in (None, 20):
            n, _ = enumerate_embeddings(q, g, limit)
            assert n == backtrack_deadend(pq, data, limit=limit).stats.found


def test_row_faults_counts_each_broken_guarantee():
    g = small_graph(np.random.default_rng(1), 8, 1.0, 1)   # complete
    q = Query(labels=np.zeros(3, np.int32),
              edges=np.array([[0, 1], [1, 2], [0, 2]]))
    good = np.array([[0, 1, 2], [3, 4, 5]])
    assert row_faults(q, g, good) == (0, 0)
    assert row_faults(q, g, np.array([[0, 0, 2]])) == (1, 0)      # injective
    assert row_faults(q, g, np.array([[0, 1, 9]])) == (1, 0)      # range
    assert row_faults(q, g, np.vstack([good, good[:1]])) == (0, 1)
    sparse = DataGraph.of({"n": 4, "labels": np.zeros(4, np.int32),
                           "indptr": to_csr(4, np.array([0, 1]),
                                            np.array([1, 2]))[0],
                           "indices": to_csr(4, np.array([0, 1]),
                                             np.array([1, 2]))[1]})
    assert row_faults(q, sparse, np.array([[0, 1, 2]])) == (1, 0)  # edge


def test_the_control_breaks_the_edge_guarantee():
    # a triangle query on a 4-cycle: only the shortcut "finds" embeddings
    indptr, indices = to_csr(4, np.array([0, 1, 2, 3]),
                             np.array([1, 2, 3, 0]))
    g = DataGraph.of({"n": 4, "labels": np.zeros(4, np.int32),
                      "indptr": indptr, "indices": indices})
    q = Query(labels=np.zeros(3, np.int32),
              edges=np.array([[0, 1], [1, 2], [0, 2]]))
    assert enumerate_embeddings(q, g, None)[0] == 0
    n, rows = enumerate_embeddings(q, g, None, keep=True,
                                   parent_edge_only=True)
    assert n > 0 and row_faults(q, g, np.array(rows))[0] == n


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.match, "
            "portbench.queries, portbench.datasets.cache; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'torch'}); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
