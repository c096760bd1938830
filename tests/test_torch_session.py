"""The port's ``MatchSession`` / ``QueryServer`` (``device="cpu"``)
against the JAX package's, end to end.

Uniform, trap and corridor workloads run through both sessions with the
same small explicit knobs; the embedding sets must equal each other and
the JAX package's sequential oracle, and every query's dead-end prunes,
rows created and patterns stored must be equal. The JAX side runs with
``REPRO_TUNING_DISABLE=1`` so both sides use the built-in knobs. Counts
and embeddings are integers: every comparison is exact.
"""
import pytest
import torch

from repro.api import MatchSession as JaxSession
from repro.core.backtrack import backtrack_deadend
from repro.data.graph_gen import (corridor_graph, er_labeled_graph,
                                  query_set, trap_graph)
from repro_torch.api import MatchSession
from repro_torch.serving import QueryServer

torch.set_num_threads(1)

KNOBS = dict(n_slots=4, wave_size=32, stack_capacity=256,
             pattern_capacity=64, limit=None)


def _workload(name):
    if name == "uniform":
        data = er_labeled_graph(40, 120, 3, seed=6)
        return data, query_set(data, 5, 3, seed=3)
    if name == "trap":
        query, data = trap_graph(8, 8)
        return data, [query] * 3
    query, data = corridor_graph(8)
    return data, [query] * 2


def _emb(embs):
    return {tuple(int(x) for x in e) for e in embs}


@pytest.mark.parametrize("workload", ["uniform", "trap", "corridor"])
def test_session_matches_reference_and_oracle(monkeypatch, workload):
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    data, queries = _workload(workload)
    jsess = JaxSession(data, **KNOBS)
    tsess = MatchSession(data, device="cpu", **KNOBS)
    jres = [h.result() for h in [jsess.submit(q) for q in queries]]
    tres = [h.result() for h in [tsess.submit(q) for q in queries]]
    _assert_same_as_reference(data, queries, jres, tres)
    assert all(b.status == a.status == "ok" for a, b in zip(jres, tres))
    if workload == "trap":
        assert sum(r.stats.deadend_prunes for r in tres) > 0


def test_stream_union_equals_blocking_result():
    data, queries = _workload("uniform")
    sess = MatchSession(data, device="cpu", **KNOBS)
    blocking = [h.result() for h in [sess.submit(q) for q in queries]]
    handles = [sess.submit(q) for q in queries]
    for h, want in zip(handles, blocking):
        rows = [r for batch in h.stream() for r in batch]
        assert len(rows) == len(want.embeddings)
        assert _emb(rows) == _emb(want.embeddings)


def test_query_server_repeat_template_hits_the_cache():
    query, data = corridor_graph(8)
    srv = QueryServer(data, backend="engine", device="cpu", **KNOBS)
    first = srv.submit(0, query)
    second = srv.submit(1, query)
    assert not first.stats.cache_hit and second.stats.cache_hit
    assert _emb(first.embeddings) == _emb(second.embeddings)
    rep = srv.slo_report()
    assert rep["n"] == 2 and rep["device"] == "cpu"
    assert rep["loop_iterations"] > 0


def test_sequential_backend_matches_oracle():
    data, queries = _workload("trap")
    srv = QueryServer(data, backend="sequential", device="cpu", limit=None)
    res = srv.submit_batch(queries[:1])
    assert _emb(res[0].embeddings) == _emb(
        backtrack_deadend(queries[0], data, limit=None).embeddings)


def _assert_same_as_reference(data, queries, jres, tres):
    for i, (q, a, b) in enumerate(zip(queries, jres, tres)):
        oracle = _emb(backtrack_deadend(q, data, limit=None).embeddings)
        assert _emb(b.embeddings) == _emb(a.embeddings) == oracle, i
        for k in ("deadend_prunes", "rows_created", "patterns_stored",
                  "injectivity_fails", "waves", "steals"):
            assert getattr(b.stats, k) == getattr(a.stats, k), (i, k)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    data, _ = _workload("uniform")
    for make in (lambda: MatchSession(data),
                 lambda: MatchSession(data, backend="sequential"),
                 lambda: QueryServer(data, backend="engine")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
