"""The port's ``run_device_megastep`` against the JAX reference, dispatch
by dispatch, on the CPU.

Both sides start from the same numpy state: the reference scheduler
admits the queries (loading its query and store banks), the state goes
over to the port through ``repro_torch.convert``, and then the same
root batches, id bases and ``t_max`` drive both steps until every query
is finished. After every dispatch each ``DeviceResult`` lane — digest,
embedding batch, the whole Δ store bank and the whole stack bank — must
be equal. Every lane is integer or bitmap: comparisons are exact (no
tolerance).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine_step as jes
from repro.core.vectorized import WaveScheduler as JaxScheduler
from repro.data.graph_gen import (corridor_graph, er_labeled_graph,
                                  query_set, trap_graph)
from repro_torch import convert
from repro_torch.core import engine_step as tes

torch.set_num_threads(1)

WAVE, KPR, SLOTS, STACK, CAP = 16, 8, 4, 128, 64


def _workload(name):
    if name == "uniform":
        data = er_labeled_graph(40, 120, 3, seed=6)
        return data, query_set(data, 4, 4, seed=3)
    if name == "trap":
        query, data = trap_graph(8, 8)
        return data, [query, query]
    query, data = corridor_graph(8)
    return data, [query, query]


def _lanes_equal(jax_nt, torch_nt, where):
    got = convert.to_numpy(torch_nt)
    for k, v in got.items():
        want = convert.as_int32(np.asarray(getattr(jax_nt, k)))
        np.testing.assert_array_equal(v, want, err_msg=f"{where}: {k}")


def admitted_reference(data, queries, **knobs):
    """A reference scheduler with ``queries`` admitted onto device
    stacks, and its active queries in slot order."""
    ref = JaxScheduler(data, n_slots=SLOTS, wave_size=WAVE, kpr=KPR // 2,
                       stack_capacity=STACK, pattern_capacity=CAP,
                       megastep_depth=6, limit=None, **knobs)
    for q in queries:
        ref.submit(q)
    ref._admit()
    active_q = sorted(ref.pool.active_queries(), key=lambda q: q.slot)
    assert active_q and all(q.device for q in active_q)
    return ref, active_q


def megastep_lockstep(ref, active_q, t_max, where):
    """Drive the reference's and the port's ``run_device_megastep``
    from the reference's admitted state with the same root batches
    until every query is finished; every lane must be equal after
    every dispatch."""
    g_t = convert.graph_arrays(ref.g, "cpu")
    qb_t = convert.query_bank(ref.qb, "cpu")
    tb_t = convert.store_bank(ref.tb, "cpu")
    sb_t = convert.stack_bank(ref.sb, "cpu")
    tb_j, sb_j = ref.tb, ref.sb

    f_in = 2 * WAVE
    emb_cap = 2 * WAVE * KPR
    cursor = {q.slot: 0 for q in active_q}
    id_base = 1
    for dispatch in range(200):
        in_root = np.full(f_in, -1, np.int32)
        in_rid = np.zeros(f_in, np.int32)
        in_slot = np.zeros(f_in, np.int32)
        in_valid = np.zeros(f_in, bool)
        active = np.zeros(SLOTS, bool)
        off = 0
        for q in active_q:
            active[q.slot] = True
            rest = q.pending_roots[cursor[q.slot]:][:f_in - off]
            k = len(rest)
            in_root[off:off + k] = rest
            in_rid[off:off + k] = np.arange(id_base, id_base + k)
            in_slot[off:off + k] = q.slot
            in_valid[off:off + k] = True
            id_base += k
            off += k
        res_j = jes.run_device_megastep(
            ref.g, ref.qb, tb_j, sb_j, in_root, in_rid, in_slot, in_valid,
            active, np.int32(id_base), True, np.int32(t_max), kpr=KPR,
            emb_cap=emb_cap, backend="jnp", wave=WAVE)
        res_t = tes.run_device_megastep(
            g_t, qb_t, tb_t, sb_t, torch.from_numpy(in_root),
            torch.from_numpy(in_rid), torch.from_numpy(in_slot),
            torch.from_numpy(in_valid), torch.from_numpy(active), id_base,
            True, t_max, kpr=KPR, emb_cap=emb_cap, wave=WAVE)
        at = f"{where} dispatch {dispatch}"
        _lanes_equal(res_j, res_t, at)
        _lanes_equal(res_j.tb, res_t.tb, at + " store bank")
        _lanes_equal(res_j.sb, res_t.sb, at + " stack bank")
        tb_j, sb_j = res_j.tb, res_j.sb
        id_base += t_max * f_in * KPR
        acc = np.asarray(res_j.d_accepted)
        for q in active_q:
            cursor[q.slot] += int(acc[q.slot])
        done = all(cursor[q.slot] >= len(q.pending_roots) for q in active_q)
        if done and not np.asarray(res_j.d_live).any():
            return
    pytest.fail("queries did not finish within 200 dispatches")


@pytest.mark.parametrize("t_max", [1, 6])
@pytest.mark.parametrize("workload", ["uniform", "trap", "corridor"])
def test_device_megastep_digest_matches_reference(monkeypatch, workload,
                                                  t_max):
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    ref, active_q = admitted_reference(*_workload(workload))
    assert ref.g.chunk_data is None
    megastep_lockstep(ref, active_q, t_max, f"{workload} t_max={t_max}")


def test_extract_topk_packed_matches_reference():
    """The one-pass top-kpr extraction against the reference's
    kpr-step lowest-bit loop, on words that use bit 31."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(64, 5), dtype=np.uint64)
    words &= rng.integers(0, 2**32, size=(64, 5), dtype=np.uint64)
    words[:8] = 0
    words[8:16, 1] = 0x80000000
    words = words.astype(np.uint32)
    for kpr in (1, 7, 40):
        cj, lj, nj = jes._extract_topk_packed(jnp.asarray(words), kpr)
        ct, lt, nt = tes._extract_topk_packed(
            torch.from_numpy(words.view(np.int32)), kpr)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(lt.numpy(),
                                      np.asarray(lj).view(np.int32))
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_eq2_matches_reference_contraction(seed):
    """refine_eq2_mq (port, plain path) against the reference's inline
    jnp gather-AND on random banks."""
    rng = np.random.default_rng(seed)
    v, f, s = 150, 24, 3
    w = (v + 31) // 32
    adj = rng.integers(0, 2**32, size=(v, w), dtype=np.uint64).astype(
        np.uint32)
    cand = rng.integers(0, 2**32, size=(s, jes.N_PAD, w),
                        dtype=np.uint64).astype(np.uint32)
    nbr = rng.random((s, jes.N_PAD, jes.N_PAD)) < 0.3
    slot = rng.integers(0, s, f).astype(np.int32)
    depth = rng.integers(1, 10, f).astype(np.int32)
    frontier = rng.integers(0, v, (f, jes.N_PAD)).astype(np.int32)
    qb_j = jes.QueryBank(jnp.asarray(cand), jnp.asarray(nbr),
                         jnp.zeros(s, jnp.int32), jnp.zeros(s, bool))
    want = jes.refine_eq2_mq(jes.GraphArrays(jnp.asarray(adj),
                                             jnp.int32(v)),
                             qb_j, jnp.asarray(slot), jnp.asarray(frontier),
                             jnp.asarray(depth))
    got = tes.refine_eq2_mq(convert.graph_arrays(adj, "cpu"),
                            convert.query_bank(qb_j, "cpu"),
                            torch.from_numpy(slot).long(),
                            torch.from_numpy(frontier),
                            torch.from_numpy(depth).long())
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).view(np.int32))

