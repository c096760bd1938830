"""Opt-in full-size cross-check of the port against the JAX package on the
CPU: ``human_like_graph`` (4674 vertices, the slice's real width) with
eight-vertex queries at default knobs. Per query, the embedding sets and
the dead-end prune, row and pattern-store counts must be equal (exact:
all integers).

It takes minutes, so tier 1 skips it. Run it with the number of queries
to check (the first ``n`` of ``query_set(…, 8, 32, seed=7)``):

    REPRO_TORCH_FULLSIZE=8 PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python -m pytest -q tests/test_torch_fullsize.py
"""
import os

import pytest
import torch

from repro.api import MatchSession as JaxSession
from repro.data.graph_gen import human_like_graph, query_set
from repro_torch.api import MatchSession


def test_human_like_default_knobs_match_reference(monkeypatch):
    n = int(os.environ.get("REPRO_TORCH_FULLSIZE", "0"))
    if n <= 0:
        pytest.skip("opt-in: set REPRO_TORCH_FULLSIZE=<queries>")
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    torch.set_num_threads(4)
    data = human_like_graph(seed=0)
    queries = query_set(data, 8, 32, seed=7)[:n]
    jsess = JaxSession(data)
    tsess = MatchSession(data, device="cpu")
    jres = [h.result() for h in [jsess.submit(q) for q in queries]]
    tres = [h.result() for h in [tsess.submit(q) for q in queries]]
    for i, (a, b) in enumerate(zip(jres, tres)):
        assert b.status == a.status, i
        assert ({tuple(map(int, e)) for e in b.embeddings}
                == {tuple(map(int, e)) for e in a.embeddings}), i
        for k in ("deadend_prunes", "rows_created", "patterns_stored"):
            assert getattr(b.stats, k) == getattr(a.stats, k), (i, k)
    print(f"{n} queries equal; wedge exports in the port: "
          f"{tsess.scheduler.n_exported}")
