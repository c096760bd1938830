"""The port's host-segment scheduling paths against the JAX package's.

Queries that do not keep their DFS stack on the device — engines with
``device_stacks=False`` or ``megastep_depth=1``, queries with
``parallelism > 1`` or ``keep_table=True``, and device stacks that wedged
and were exported — run on host segments through the fused ring
megastep, the single-step expansion and the leftover pass. Each runs
through both sessions (``device="cpu"`` for the port, built-in knobs on
both sides via ``REPRO_TUNING_DISABLE=1``); embedding sets must equal
each other and the sequential oracle, and every per-query counter must
be equal. Everything compared is an integer: exact, no tolerance.
"""
import numpy as np
import pytest
import torch

from repro.api import MatchSession as JaxSession
from repro.core.backtrack import backtrack_deadend
from repro.core.vectorized import match_vectorized as jax_match_vectorized
from repro.data.graph_gen import er_labeled_graph, query_set, trap_graph
from repro_torch.api import MatchSession
from repro_torch.core.vectorized import match_vectorized

torch.set_num_threads(1)

KNOBS = dict(n_slots=4, wave_size=32, stack_capacity=256,
             pattern_capacity=64, limit=None)


def _emb(embs):
    return {tuple(int(x) for x in e) for e in embs}


def _assert_same_as_reference(data, queries, jres, tres):
    for i, (q, a, b) in enumerate(zip(queries, jres, tres)):
        oracle = _emb(backtrack_deadend(q, data, limit=None).embeddings)
        assert _emb(b.embeddings) == _emb(a.embeddings) == oracle, i
        for k in ("deadend_prunes", "rows_created", "patterns_stored",
                  "injectivity_fails", "waves", "steals"):
            assert getattr(b.stats, k) == getattr(a.stats, k), (i, k)


@pytest.mark.parametrize("engine,per_query", [
    ({"device_stacks": False}, {}), ({"megastep_depth": 1}, {}),
    ({}, {"parallelism": 2}), ({}, {"keep_table": True})])
def test_host_segment_paths_match_reference(monkeypatch, engine,
                                            per_query):
    """The host-scheduled programs (fused ring megastep, single step,
    leftover pass) behind device_stacks=False, megastep_depth=1,
    parallelism > 1 and keep_table, against the reference."""
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    query, data = trap_graph(8, 8)
    queries = [query, query]
    jsess = JaxSession(data, **KNOBS, **engine)
    tsess = MatchSession(data, device="cpu", **KNOBS, **engine)
    jres = [h.result() for h in [jsess.submit(q, **per_query)
                                 for q in queries]]
    tres = [h.result() for h in [tsess.submit(q, **per_query)
                                 for q in queries]]
    _assert_same_as_reference(data, queries, jres, tres)
    if per_query.get("keep_table"):
        for a, b in zip(jres, tres):
            jt = jsess.scheduler.tables[a.query_id]
            tt = tsess.scheduler.tables[b.query_id]
            for k in jt:
                np.testing.assert_array_equal(tt[k], jt[k])


def test_wedged_device_stack_is_exported_like_the_reference(monkeypatch):
    """A stack too small for its fan-out stalls; after three identical
    digests the query moves to host segments and finishes there."""
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    data = er_labeled_graph(30, 150, 2, seed=6)
    queries = query_set(data, 5, 2, seed=4)
    knobs = dict(n_slots=2, wave_size=16, stack_capacity=32,
                 pattern_capacity=32, kpr=2, limit=None)
    jsess = JaxSession(data, **knobs)
    jres = [h.result() for h in [jsess.submit(q) for q in queries]]
    tsess = MatchSession(data, device="cpu", **knobs)
    tres = [h.result() for h in [tsess.submit(q) for q in queries]]
    assert tsess.scheduler.n_exported > 0
    _assert_same_as_reference(data, queries, jres, tres)


def test_match_vectorized_one_shot(monkeypatch):
    """The single-query facade (one slot, keep_table) against the
    reference's."""
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    query, data = trap_graph(8, 8)
    knobs = dict(limit=None, wave_size=32, stack_capacity=256,
                 pattern_capacity=64)
    want = jax_match_vectorized(query, data, **knobs)
    got = match_vectorized(query, data, device="cpu", **knobs)
    _assert_same_as_reference(data, [query], [want], [got])
