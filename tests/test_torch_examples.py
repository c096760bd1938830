"""The port's serving examples (``examples/quickstart_torch.py`` and
``examples/serve_queries_torch.py``) against the JAX package, on the
CPU.

Each part of each example is called as a function (``device="cpu"``;
smaller sizes where the reference example's defaults are too slow for
tier-1) and held against the reference package's functions on the same
seeds and inputs:

* quickstart: the Fig. 1 example's counts, recursions and embeddings;
  trap(100)'s pruned and plain recursions; ``match_vectorized`` on that
  trap (found, waves, rows, prunes and the embedding set); the 12-vertex
  yeast-like query's found and recursions;
* serve_queries: the batched workload at 6 queries with a 600 s budget
  (every query's status, count and embedding set, the heavy query's
  per-shard rows, items and steals), against both the reference
  ``QueryServer`` and the reference's sequential oracle: a finished
  query gives the oracle's set, a capped one 1000 valid distinct rows;
  the distributed trap at ``n_b = 40`` (found, rows, prunes, and the
  oracle's set); the streaming demo at ``n_b = 30`` (the streamed rows
  are the oracle's set; the cancelled query ends ``cancelled`` with
  valid rows, whatever their count); and ``--server`` against a port
  server subprocess (``--device cpu``).
"""
import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import backtrack as JB
from repro.core.distributed import DistributedMatcher as JDistributed
from repro.core.graph import Graph as JGraph
from repro.core.vectorized import match_vectorized as j_match_vectorized
from repro.data import graph_gen as JG
from repro.serving import QueryServer as JQueryServer

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 120


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


qs = _load("quickstart_torch")
sq = _load("serve_queries_torch")


@pytest.fixture(autouse=True)
def _builtin_knobs(monkeypatch):
    """Both packages on their built-in engine knobs (the reference's
    committed tuning record would move its knobs on small graphs)."""
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    monkeypatch.setenv("REPRO_TORCH_TUNING_DISABLE", "1")


def _emb_set(embs) -> set:
    return {tuple(int(x) for x in np.asarray(e).tolist()) for e in embs}


def _valid(rows, query, data) -> bool:
    """Every row an injective, label- and edge-preserving embedding."""
    for r in rows:
        r = [int(x) for x in np.asarray(r).tolist()]
        if len(set(r)) != query.n:
            return False
        if any(data.labels[v] != query.labels[u] for u, v in enumerate(r)):
            return False
        for u in range(query.n):
            for w in query.neighbors(u):
                if not data.has_edge(r[u], r[int(w)]):
                    return False
    return True


def _check_served(rows, status: str, query, data, oracle) -> None:
    """The example rules: a finished query gives the oracle's set, a
    capped one 1000 valid distinct rows, any other valid rows."""
    assert _valid(rows, query, data)
    assert len(_emb_set(rows)) == len(rows)
    if status == "ok":
        assert _emb_set(rows) == _emb_set(oracle.embeddings)
    elif status == "limit":
        assert len(rows) == 1000


# ------------------------------------------------------------ quickstart
def test_quickstart_paper_example():
    got = qs.paper_example()
    query = JGraph.from_edges(4, [(0, 1), (1, 2), (2, 3)], [0, 1, 2, 0])
    data = JGraph.from_edges(
        7, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (4, 5), (5, 6)],
        [0, 1, 2, 0, 1, 2, 0])
    want = JB.backtrack_deadend(query, data, limit=None)
    assert (got["found"], got["recursions"]) == (want.stats.found,
                                                 want.stats.recursions)
    assert _emb_set(got["embeddings"]) == _emb_set(want.embeddings)
    assert got["found"] == 2


def test_quickstart_trap_and_wave_engine():
    trap = qs.trap_pruning(100)
    jq, jg = JG.trap_graph(n_b=100, n_c=100, n_good=2, tail_len=2)
    assert np.array_equal(trap["data"].adj_bitmap, jg.adj_bitmap)
    pruned = JB.backtrack_deadend(jq, jg, limit=None)
    plain = JB.backtrack_deadend(jq, jg, limit=None, use_pruning=False)
    assert trap["pruned_recursions"] == pruned.stats.recursions
    assert trap["plain_recursions"] == plain.stats.recursions
    assert trap["found"] == trap["plain_found"] == pruned.stats.found

    eng = qs.wave_engine(trap["query"], trap["data"], trap["found"],
                         device="cpu")
    ref = j_match_vectorized(jq, jg, limit=None, wave_size=256, kpr=16)
    assert (eng["found"], eng["waves"], eng["rows"], eng["prunes"]) == (
        ref.stats.found, ref.stats.waves, ref.stats.rows_created,
        ref.stats.deadend_prunes)
    assert _emb_set(eng["embeddings"]) == _emb_set(pruned.embeddings)


def test_quickstart_yeast_query():
    got = qs.yeast_query()
    big = JG.yeast_like_graph(0)
    want = JB.backtrack_deadend(JG.random_walk_query(big, 12, seed=5), big,
                                limit=1000)
    assert got["n_vertices"] == big.n == 3112
    assert (got["found"], got["recursions"]) == (want.stats.found,
                                                 want.stats.recursions)


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    q, g = qs.trap_pruning(4)["query"], qs.trap_pruning(4)["data"]
    with pytest.raises(RuntimeError, match="CUDA"):
        qs.wave_engine(q, g, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        sq.stream_demo(n=4)


# ---------------------------------------------------------- serve_queries
def test_serve_batched_workload_equals_the_reference():
    data = sq.yeast_like_graph(0)
    jdata = JG.yeast_like_graph(0)
    got = sq.batched_workload(data, 6, 10, device="cpu",
                              time_budget_s=600.0)
    heavy = max((JG.random_walk_query(jdata, 3, seed=s) for s in range(8)),
                key=lambda q: len(JB._prepare(q, jdata, None, None)[0][0]))
    queries = JG.query_set(jdata, 10, 6, seed=42) + [heavy]
    par = [1] * 6 + [8]
    want = JQueryServer(jdata, backend="engine", limit=1000,
                        time_budget_s=600.0).submit_batch(queries,
                                                          parallelism=par)
    assert got["heavy_i"] == 6 and len(got["results"]) == 7
    assert got["engine"]["source"] == "builtin"
    for i, (g, w, q) in enumerate(zip(got["results"], want, queries)):
        assert np.array_equal(got["queries"][i].adj_bitmap, q.adj_bitmap)
        assert (g.status, g.n_found) == (w.status, w.n_found), i
        assert _emb_set(g.embeddings) == _emb_set(w.embeddings), i
        _check_served(g.embeddings, g.status, q, jdata,
                      JB.backtrack_deadend(q, jdata, limit=None))
    hs, ws = got["results"][6].stats, want[6].stats
    assert (hs.rows_created, hs.steals, list(hs.shard_rows),
            list(hs.shard_items)) == (ws.rows_created, ws.steals,
                                      list(ws.shard_rows),
                                      list(ws.shard_items))
    assert got["timed_out"] == 0 and got["found"] == sum(
        w.n_found for w in want)


def test_serve_distributed_trap_equals_the_reference():
    got = sq.distributed_trap("cpu", n=40)
    jq, jg = JG.trap_graph(n_b=40, n_c=40, n_good=2, tail_len=2)
    want = JDistributed(jg, n_shards=4, wave_size=128, kpr=8).match(
        jq, limit=None)
    assert (got["found"], got["rows"], got["prunes"]) == (
        want.stats.found, want.stats.recursions, want.stats.deadend_prunes)
    oracle = JB.backtrack_deadend(jq, jg, limit=None)
    assert _emb_set(got["embeddings"]) == _emb_set(oracle.embeddings)
    assert got["found"] == oracle.stats.found > 0


def test_serve_stream_demo_and_cancel():
    got = sq.stream_demo("cpu", n=30)
    jq, jg = JG.trap_graph(n_b=30, n_c=30, n_good=2, tail_len=2)
    oracle = JB.backtrack_deadend(jq, jg, limit=None)
    assert got["status"] == "ok" and got["n_batches"] >= 1
    assert _emb_set(got["rows"]) == _emb_set(oracle.embeddings)
    assert len(got["rows"]) == oracle.stats.found
    assert got["ttfe_s"] <= got["latency_s"]
    # a cancelled query's partial count varies: status and validity only
    assert got["cancelled_status"] == "cancelled"
    assert _valid(got["cancelled_rows"], jq, jg)
    assert _emb_set(got["cancelled_rows"]) <= _emb_set(oracle.embeddings)


SERVER = ["--device", "cpu", "--graph", "ba", "--graph-n", "128",
          "--graph-m", "3", "--graph-labels", "4", "--graph-extra-edges",
          "128", "--graph-seed", "5", "--warmup-queries", "1", "--quiet",
          "--port", "0"]


def test_serve_against_a_port_server():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.server.launch", *SERVER],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        box = {}

        def read():
            for line in proc.stdout:
                if line.startswith("REPRO_SERVER_READY "):
                    box["info"] = json.loads(line.split(" ", 1)[1])
                    return

        t = threading.Thread(target=read, daemon=True)
        t.start()
        t.join(timeout=WAIT_S)
        assert "info" in box, proc.stderr.read()[-2000:]
        got = sq.main(["--server", f"127.0.0.1:{box['info']['port']}",
                       "--n-queries", "4", "--query-size", "4"])["server"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    assert rc == 0
    jdata = JG.ba_labeled_graph(128, 3, 4, extra_edges=128, seed=5)
    assert np.array_equal(got["data"].adj_bitmap, jdata.adj_bitmap)
    assert len(got["results"]) == 4 and sum(got["statuses"].values()) == 3
    for q, rows, res in zip(got["queries"], got["rows"], got["results"]):
        jq = JGraph.from_edges(q.n, [(a, int(b)) for a in range(q.n)
                                     for b in q.neighbors(a) if a < b],
                               q.labels.tolist(), q.n_labels)
        _check_served(rows, res["status"], jq, jdata,
                      JB.backtrack_deadend(jq, jdata, limit=None))
        assert res["status"] in ("ok", "limit")
        assert res["n_found"] == len(rows)
