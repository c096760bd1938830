"""The port's hierarchical ("two-level") adjacency path against the JAX
package's, on the CPU.

Graphs of 16384 or more vertices keep their adjacency as per-row chunk
summaries plus a store of the nonzero chunks (``HierBitmap``), and every
Eq. 2 refine goes through ``refine_bitmap_rows_hier``. Here, at small
sizes, the port's layout construction, power-law generator, plain hier refine,
hier megastep and hier sessions are held against the reference's: the
layout lane for lane, the refine bit for bit against the reference's
jnp oracle and its Pallas kernel in interpret mode, the megastep digest
for digest, and the sessions on embedding sets and per-query counters.
Every lane is an integer or a packed bitmap word, so every comparison is
exact (no tolerance). Inputs come from numpy with a seed. The CUDA
kernel's own test, which needs a card, is in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.api import MatchSession as JaxSession
from repro.core import graph as jgraph
from repro.core.backtrack import backtrack_deadend
from repro.core.vectorized import WaveScheduler as JaxScheduler
from repro.data import graph_gen as jgen
from repro.kernels.ops import refine_bitmap_rows_hier_op
from repro_torch import convert
from repro_torch.api import MatchSession
from repro_torch.core.backtrack import backtrack_deadend as port_oracle
from repro_torch.core import graph as tgraph
from repro_torch.core.vectorized import WaveScheduler
from repro_torch.data import graph_gen as tgen
from repro_torch.kernels import bitmap_refine
from repro_torch.kernels.ref import (refine_bitmap_rows_hier_ref,
                                     refine_bitmap_rows_ref)

from test_torch_engine_step import (_workload, admitted_reference,
                                    megastep_lockstep)

torch.set_num_threads(1)

# the four layouts of tests/test_kernels.py's hier grid
LAYOUTS = [
    (48, 6, 5, 1, 0),       # C=1: every chunk is a single word
    (300, 16, 8, 8, 1),     # default chunk width, W=10 > C
    (520, 24, 9, 4, 2),     # multi-word rows, ragged F
    (64, 1, 3, 16, 3),      # C > W: one chunk spans the whole row
]
SESSION_KNOBS = dict(n_slots=4, wave_size=32, stack_capacity=256,
                     pattern_capacity=64, limit=None,
                     hier_adjacency=True, chunk_words=4)


def _random_graph_csr(v, seed, density=0.2):
    rng = np.random.default_rng(seed)
    dense = rng.random((v, v)) < density
    dense |= dense.T
    indptr = np.concatenate(
        ([0], np.cumsum(dense.sum(axis=1)))).astype(np.int64)
    indices = np.nonzero(dense)[1].astype(np.int64)
    return dense, indptr, indices


def _i32(a):
    return torch.from_numpy(convert.as_int32(np.array(a)))


def _refine_inputs(v, f, np_, seed, past_v=False):
    """cand words, frontier and active as numpy; with ``past_v`` every
    third row from row 1 gets an active frontier value past V - 1, every
    other one of them as its only active position."""
    rng = np.random.default_rng(seed + 100)
    cand = jgraph.pack_bitmap(rng.random((f, v)) < 0.5)
    frontier = rng.integers(-1, v, size=(f, np_)).astype(np.int32)
    active = (rng.random((f, np_)) < 0.6).astype(np.int32)
    if past_v:
        rows = np.arange(1, f, 3)
        active[rows[::2]] = 0
        frontier[rows, 0] = v + rows % 7
        active[rows, 0] = 1
    return cand, frontier, active


def _hier_lanes(hb):
    return [hb.summary, hb.chunk_ptr, hb.chunk_id, hb.chunk_data]


@pytest.mark.parametrize("v,f,np_,cw,seed", LAYOUTS)
def test_build_hier_bitmap_matches_reference(v, f, np_, cw, seed):
    _, indptr, indices = _random_graph_csr(v, seed)
    want = jgraph.build_hier_bitmap(v, indptr, indices, chunk_words=cw)
    got = tgraph.build_hier_bitmap(v, indptr, indices, chunk_words=cw)
    for name in ("summary", "chunk_ptr", "chunk_id", "chunk_data"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(convert.as_int32(a),
                                      convert.as_int32(b), err_msg=name)
    assert (got.kmax, got.n_chunks, got.chunk_words, got.n_stored,
            got.nbytes) == (want.kmax, want.n_chunks, want.chunk_words,
                            want.n_stored, want.nbytes)


@pytest.mark.parametrize("cw", [0, 3, 6, 256])
def test_build_hier_bitmap_rejects_bad_chunk_words(cw):
    _, indptr, indices = _random_graph_csr(64, 0)
    with pytest.raises(ValueError, match="power of two"):
        tgraph.build_hier_bitmap(64, indptr, indices, chunk_words=cw)


@pytest.mark.parametrize("degree_sorted", [True, False])
def test_powerlaw_graph_matches_reference(degree_sorted):
    want = jgen.powerlaw_graph(2048, 3, 16, seed=0,
                               degree_sorted=degree_sorted)
    got = tgen.powerlaw_graph(2048, 3, 16, seed=0,
                              degree_sorted=degree_sorted)
    assert (got.n, got.n_labels) == (want.n, want.n_labels)
    for name in ("labels", "indptr", "indices"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    order = tgraph.degree_descending_order(got)
    np.testing.assert_array_equal(order,
                                  jgraph.degree_descending_order(want))
    if not degree_sorted:
        a, b = got.relabel(order), want.relabel(order)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.labels, b.labels)
    hb_t, hb_j = got.hier_bitmap(8), want.hier_bitmap(8)
    assert got.hier_bitmap(8) is hb_t              # cached per width
    for a, b in zip(_hier_lanes(hb_t), _hier_lanes(hb_j)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("v,f,np_,cw,seed", LAYOUTS)
def test_plain_hier_refine_matches_reference(backend, v, f, np_, cw, seed):
    """Bit for bit against the reference's hier refine, and against the
    port's dense plain version on the same graph. Some rows carry an
    active frontier value past V - 1: there the port follows the
    reference's kernel (``pallas_interpret``), which ANDs
    ``summary[V - 1]`` and no chunk. The reference's jnp oracle ANDs an
    empty row there instead (zeroing it), so against ``jnp`` those rows
    are left out."""
    dense, indptr, indices = _random_graph_csr(v, seed)
    hb = jgraph.build_hier_bitmap(v, indptr, indices, chunk_words=cw)
    cand, frontier, active = _refine_inputs(v, f, np_, seed, past_v=True)
    want = np.asarray(refine_bitmap_rows_hier_op(
        *map(jnp.asarray, _hier_lanes(hb)), hb.kmax, jnp.asarray(cand),
        jnp.asarray(frontier), jnp.asarray(active), backend=backend))
    got = refine_bitmap_rows_hier_ref(*map(_i32, _hier_lanes(hb)), hb.kmax,
                                      _i32(cand), _i32(frontier),
                                      _i32(active)).numpy()
    past = ((frontier >= v) & (active != 0)).any(axis=1)
    assert past.any() == (f > 1) and not past.all()
    assert got[past].any() == (f > 1)       # past-V rows are not all zero
    keep = ~past if backend == "jnp" else np.ones(f, bool)
    np.testing.assert_array_equal(got[keep], want.view(np.int32)[keep])
    dense_out = refine_bitmap_rows_ref(
        _i32(jgraph.pack_bitmap(dense)), _i32(cand), _i32(frontier),
        _i32(active)).numpy()
    np.testing.assert_array_equal(got[~past], dense_out[~past])


@pytest.mark.parametrize("dma_depth", [1, 3])
def test_hier_refine_dma_depth_changes_no_bit(dma_depth):
    dense, indptr, indices = _random_graph_csr(200, 7)
    hb = tgraph.build_hier_bitmap(200, indptr, indices, chunk_words=8)
    cand, frontier, active = _refine_inputs(200, 12, 6, 8)
    args = (*map(_i32, _hier_lanes(hb)), hb.kmax, _i32(cand),
            _i32(frontier), _i32(active))
    before = bitmap_refine.HIER_LAUNCHES
    got = bitmap_refine.refine_bitmap_rows_hier(*args, dma_depth=dma_depth)
    assert bitmap_refine.HIER_LAUNCHES == before      # CPU: plain path
    np.testing.assert_array_equal(got.numpy(),
                                  refine_bitmap_rows_hier_ref(*args).numpy())
    want = refine_bitmap_rows_ref(_i32(jgraph.pack_bitmap(dense)),
                                  *args[5:]).numpy()
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="dma_depth"):
        bitmap_refine.refine_bitmap_rows_hier(*args, dma_depth=0)


def test_convert_graph_arrays_of_reference_hier_layout(monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    data, _ = _workload("uniform")
    ref = JaxScheduler(data, n_slots=2, wave_size=16, hier_adjacency=True,
                       chunk_words=4)
    g = convert.graph_arrays(ref.g, "cpu")
    hb = data.hier_bitmap(4)
    assert g.adj_bitmap is None and g.n_vertices == data.n
    assert g.kmax == hb.kmax
    for t, a in zip((g.adj_summary, g.chunk_ptr, g.chunk_id, g.chunk_data),
                    _hier_lanes(hb)):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), convert.as_int32(a))
    dense = convert.graph_arrays(JaxScheduler(data, n_slots=2).g, "cpu")
    assert dense.chunk_data is None
    np.testing.assert_array_equal(dense.adj_bitmap.numpy(),
                                  data.adj_bitmap.view(np.int32))


@pytest.mark.parametrize("t_max", [1, 6])
@pytest.mark.parametrize("workload", ["uniform", "trap", "corridor"])
def test_hier_megastep_digest_matches_reference(monkeypatch, workload,
                                                t_max):
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    ref, active_q = admitted_reference(*_workload(workload),
                                       hier_adjacency=True, chunk_words=4)
    assert ref.g.chunk_data is not None
    megastep_lockstep(ref, active_q, t_max,
                      f"hier {workload} t_max={t_max}")


def _session_workload(name):
    if name == "uniform":
        data = jgen.er_labeled_graph(40, 120, 3, seed=2)
        return data, jgen.query_set(data, 4, 4, seed=3)
    if name == "trap":
        query, data = jgen.trap_graph(8, 8)
        return data, [query] * 3
    query, data = jgen.corridor_graph(8)
    return data, [query] * 2


def _emb(embs):
    return {tuple(int(x) for x in e) for e in embs}


@pytest.mark.parametrize("workload", ["uniform", "trap", "corridor"])
def test_hier_session_matches_reference_dense_and_oracle(monkeypatch,
                                                         workload):
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    data, queries = _session_workload(workload)
    legs = {"jax": JaxSession(data, **SESSION_KNOBS),
            "hier": MatchSession(data, device="cpu", **SESSION_KNOBS),
            "dense": MatchSession(data, device="cpu", **{
                **SESSION_KNOBS, "hier_adjacency": False})}
    res = {k: [h.result() for h in [s.submit(q) for q in queries]]
           for k, s in legs.items()}
    assert legs["hier"].scheduler.adjacency_variant == "hier-hbm"
    assert legs["dense"].scheduler.adjacency_variant == "dense-vmem"
    for i, q in enumerate(queries):
        oracle = _emb(backtrack_deadend(q, data, limit=None).embeddings)
        a = res["jax"][i]
        for leg in ("hier", "dense"):
            b = res[leg][i]
            assert b.status == a.status == "ok", (leg, i)
            assert _emb(b.embeddings) == _emb(a.embeddings) == oracle, i
            for k in ("deadend_prunes", "rows_created", "patterns_stored",
                      "injectivity_fails", "waves", "steals"):
                assert getattr(b.stats, k) == getattr(a.stats, k), (leg, i,
                                                                    k)
    if workload == "trap":
        assert sum(r.stats.deadend_prunes for r in res["hier"]) > 0


@pytest.mark.parametrize("hier", [False, True])
def test_scheduler_stats_layout_keys_match_reference(monkeypatch, hier):
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    data, _ = _workload("uniform")
    knobs = dict(n_slots=2, wave_size=16, hier_adjacency=hier)
    want = JaxScheduler(data, **knobs).scheduler_stats()
    got = WaveScheduler(data, device="cpu", **knobs).scheduler_stats()
    for k in ("adjacency_variant", "adjacency_bytes", "chunk_words"):
        assert got[k] == want[k], k
    assert got["adjacency_variant"] == ("hier-hbm" if hier
                                        else "dense-vmem")


def test_large_graph_picks_hier_layout_and_serves():
    """At 16384 vertices, with no knob set, the threshold picks the hier
    layout, and a query is served through it."""
    data = tgen.powerlaw_graph(16384, 3, 16, seed=0)
    sess = MatchSession(data, device="cpu", n_slots=2, wave_size=64,
                        stack_capacity=128, limit=50)
    st = sess.scheduler.scheduler_stats()
    assert st["adjacency_variant"] == "hier-hbm"
    assert st["chunk_words"] == 8
    assert st["adjacency_bytes"] == data.hier_bitmap(8).nbytes
    assert sess.scheduler.g.adj_bitmap is None
    assert data._bitmap is None               # dense block never built
    query = tgen.query_set(data, 4, 1, seed=1)[0]
    res = sess.submit(query).result()
    want = port_oracle(query, data, limit=50)
    assert res.status in ("ok", "limit")
    assert len(res.embeddings) == len(want.embeddings)
    assert all(len(set(e.tolist())) == query.n for e in res.embeddings)


def test_convert_graph_arrays_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    adj = np.zeros((4, 1), np.uint32)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.graph_arrays(adj)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.to_tensor(adj)
    assert convert.graph_arrays(adj, "cpu").adj_bitmap.device.type == "cpu"
