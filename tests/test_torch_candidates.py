"""The port's candidate filters (``repro_torch.core.candidates``) against
the reference's (``repro.core.candidates``), on the CPU.

The port builds the data graph's neighbor-label table once per graph and
sweeps CFL over the CSR rows of each query vertex's candidates only (the
whole CSR where the candidates' degree sum nears it); the reference
rebuilds the table on every call and sweeps the whole CSR for every
pair. Their candidate lists must be array-equal: every filter
combination, on a human-like graph (Q4, Q8, Q16), a single-label graph
(the whole-CSR branch), empty CSR rows, a query label beyond the data
alphabet, a candidate set that empties mid-sweep and a corridor whose
emptiness the 3-round cap cuts short. Then the table's cache and the
two counters, ``nlf_table_builds`` and ``cfl_rows``, of a scheduler.
"""
import numpy as np
import pytest
import torch

from repro.core import candidates as ref_cand
from repro.core import graph as ref_graph
from repro_torch.core import candidates
from repro_torch.core.graph import Graph
from repro_torch.core.vectorized import WaveScheduler
from repro_torch.data import graph_gen

torch.set_num_threads(1)

FILTERS = [(True, True), (True, False), (False, True), (False, False)]


def _ref(g: Graph) -> ref_graph.Graph:
    return ref_graph.Graph(n=g.n, labels=g.labels, indptr=g.indptr,
                           indices=g.indices, n_labels=g.n_labels)


def _assert_lists_equal(got, want, where):
    assert len(got) == len(want), where
    for u, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, (where, u)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: u={u}")


@pytest.fixture(scope="module")
def human():
    return graph_gen.human_like_graph(0)


def _human(k):
    def build(request):
        data = request.getfixturevalue("human")
        return data, graph_gen.query_set(data, k, 6, seed=k)
    return build


def _single_label(request):
    data = graph_gen.er_labeled_graph(300, 3000, 1, seed=4)
    return data, (graph_gen.query_set(data, 4, 3, seed=1)
                  + graph_gen.query_set(data, 8, 3, seed=2))


def _isolated(request):
    """Vertices 30-39 have no edges: empty CSR rows, which LDF keeps for a
    query vertex of degree 0 and CFL must drop when handed them."""
    base = graph_gen.er_labeled_graph(30, 70, 2, seed=5)
    edges = [(int(a), int(b)) for a in range(base.n)
             for b in base.neighbors(a) if a < b]
    labels = np.concatenate([base.labels, np.arange(10) % 2])
    data = Graph.from_edges(40, edges, labels, 2)
    lone = Graph.from_edges(2, [], [0, 1], 2)
    return data, graph_gen.query_set(data, 4, 3, seed=6) + [lone]


def _beyond_alphabet(request):
    """Label 3 does not occur in the data (alphabet 0-2)."""
    data = graph_gen.er_labeled_graph(50, 150, 3, seed=7)
    path = Graph.from_edges(3, [(0, 1), (1, 2)], [0, 1, 3], 4)
    star = Graph.from_edges(4, [(0, 1), (0, 2), (0, 3)], [2, 0, 1, 3], 4)
    return data, [path, star]


def _chain_data():
    """A chain r(0)-p(1)-q(2)-s(3) and a random block of label 5."""
    block = graph_gen.er_labeled_graph(40, 160, 1, seed=8)
    edges = [(0, 1), (1, 2), (2, 3)] + [
        (4 + int(a), 4 + int(b)) for a in range(block.n)
        for b in block.neighbors(a) if a < b]
    return Graph.from_edges(44, edges, [0, 1, 2, 3] + [5] * 40, 6)


def _empties(request):
    """Query path 0-1-2-3-4: NLF drops s (no label-4 neighbor), so C[u3]
    is empty and CFL empties C[u2] in its first sweep, C[u1] and C[u0]
    in the next two."""
    query = Graph.from_edges(5, [(0, 1), (1, 2), (2, 3), (3, 4)],
                             [0, 1, 2, 3, 4], 6)
    return _chain_data(), [query]


def _capped(request):
    """The corridor graph: each bait's emptiness needs 4 propagation
    hops, one more than CFL's 3 sweeps, so the sweep order decides what
    is left."""
    query, data = graph_gen.corridor_graph(8, n_spines=2)
    return data, [query]


CASES = {"human-q4": _human(4), "human-q8": _human(8),
         "human-q16": _human(16), "single-label": _single_label,
         "isolated": _isolated, "beyond-alphabet": _beyond_alphabet,
         "empties": _empties, "capped": _capped}


@pytest.mark.parametrize("use_nlf,use_cfl", FILTERS)
@pytest.mark.parametrize("case", list(CASES))
def test_candidates_equal_the_reference(case, use_nlf, use_cfl, request,
                                        monkeypatch):
    data, queries = CASES[case](request)
    gathers = []
    rows_of = candidates._rows_of
    monkeypatch.setattr(candidates, "_rows_of",
                        lambda d, r: gathers.append(len(r)) or rows_of(d, r))
    ref_data = _ref(data)
    for i, q in enumerate(queries):
        got = candidates.build_candidates(q, data, use_nlf=use_nlf,
                                          use_cfl=use_cfl)
        want = ref_cand.build_candidates(_ref(q), ref_data,
                                         use_nlf=use_nlf, use_cfl=use_cfl)
        _assert_lists_equal(got, want, f"{case} query {i}")
    if use_cfl and case.startswith("human"):
        assert gathers, "the gather branch never ran"
    if case == "single-label":
        assert not gathers, "the whole-CSR branch never ran"


def test_the_cases_are_what_they_say():
    data, (query,) = _empties(None)
    after_nlf = candidates.nlf_filter(query, data,
                                      candidates.ldf_filter(query, data))
    assert [len(c) for c in after_nlf] == [1, 1, 1, 0, 0]
    masks = [np.isin(np.arange(data.n), c) for c in after_nlf]
    assert candidates._refine_once(query, data, masks)
    assert [int(m.sum()) for m in masks] == [1, 1, 0, 0, 0]
    assert [len(c) for c in candidates.build_candidates(query, data)] == [0] * 5

    data, (query,) = _capped(None)
    cand = candidates.nlf_filter(query, data,
                                 candidates.ldf_filter(query, data))
    capped = candidates.cfl_refine(query, data, cand)
    fixpoint = candidates.cfl_refine(query, data, cand, max_rounds=10)
    assert sum(map(len, capped)) > sum(map(len, fixpoint))

    # NLF kills u1 (its neighbor's label 3 is past the alphabet); LDF
    # finds no vertex of label 3 for u2
    data, queries = _beyond_alphabet(None)
    cand = candidates.build_candidates(queries[0], data, use_cfl=False)
    assert len(cand[0]) > 0 and len(cand[1]) == len(cand[2]) == 0


@pytest.mark.parametrize("case", ["isolated", "human-q8", "no-edges"])
def test_cfl_on_raw_candidates_equals_the_reference(case, request):
    """CFL handed every vertex of the label, empty rows included."""
    if case == "no-edges":
        data = Graph.from_edges(12, [], np.arange(12) % 2, 2)
        queries = [Graph.from_edges(3, [(0, 1), (1, 2)], [0, 1, 0], 2)]
    else:
        data, queries = CASES[case](request)
    for i, q in enumerate(queries):
        cand = [data.label_index.get(int(lab), np.empty(0, np.int32))
                for lab in q.labels]
        got = candidates.cfl_refine(q, data, cand)
        want = ref_cand.cfl_refine(_ref(q), _ref(data), cand)
        _assert_lists_equal(got, want, f"{case} query {i}")


def test_one_table_per_scheduler_and_rows_counted():
    data = graph_gen.er_labeled_graph(60, 240, 3, seed=9)
    queries = graph_gen.query_set(data, 4, 6, seed=10)
    sched = WaveScheduler(data, device="cpu", n_slots=4, wave_size=32,
                          stack_capacity=128, pattern_capacity=64,
                          limit=None)
    rows = []
    for q in queries:
        sched.submit(q)
        rows.append(sched.timing["cfl_rows"])
        assert sched.timing["nlf_table_builds"] == 1
    assert all(b > a for a, b in zip(rows, rows[1:])), rows
    counters = sched.scheduler_stats()["counters"]
    assert counters["nlf_table_builds"] == 1
    assert counters["cfl_rows"] == rows[-1]


def test_the_cached_table_is_read_only_and_relabel_has_its_own():
    data = graph_gen.er_labeled_graph(50, 200, 4, seed=11)
    table = data.neighbor_label_counts
    assert data.neighbor_label_counts is table
    with pytest.raises(ValueError):
        table[0, 0] = 7
    order = np.random.default_rng(0).permutation(data.n)
    copy = data.relabel(order)
    fresh = Graph(n=copy.n, labels=copy.labels, indptr=copy.indptr,
                  indices=copy.indices, n_labels=copy.n_labels)
    assert copy.neighbor_label_counts is not table
    np.testing.assert_array_equal(copy.neighbor_label_counts,
                                  fresh.neighbor_label_counts)
    np.testing.assert_array_equal(copy.neighbor_label_counts, table[order])
    np.testing.assert_array_equal(
        table, ref_graph.Graph(n=data.n, labels=data.labels,
                               indptr=data.indptr, indices=data.indices,
                               n_labels=data.n_labels).neighbor_label_counts)
