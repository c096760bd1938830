"""The port's host-scheduled wave programs against the JAX package's,
lane for lane, on the CPU: the fused ring megastep (``run_megastep_mq``),
the single-step expansion (``expand_wave_mq``), the leftover pass
(``extract_more_mq``) and child assembly (``assemble_children_mq``).

Inputs are a real packed wave: the reference scheduler, on its
host-segment path, admits the queries and packs one fresh wave; the
banks go over through ``repro_torch.convert``. Every lane is integer or
bitmap: comparisons are exact (no tolerance).
"""
import numpy as np
import pytest
import torch

from repro.core import engine_step as jes
from repro.core.vectorized import WaveScheduler as JaxScheduler
from repro.data.graph_gen import er_labeled_graph, query_set, trap_graph
from repro_torch import convert
from repro_torch.core import engine_step as tes

torch.set_num_threads(1)

WAVE, KPR, SLOTS, STACK, CAP = 16, 8, 4, 128, 64


def _workload(name):
    if name == "uniform":
        data = er_labeled_graph(40, 120, 3, seed=6)
        return data, query_set(data, 4, 4, seed=3)
    query, data = trap_graph(8, 8)
    return data, [query, query]


def _lanes_equal(jax_nt, torch_nt, where):
    got = convert.to_numpy(torch_nt)
    for k, v in got.items():
        want = convert.as_int32(np.asarray(getattr(jax_nt, k)))
        np.testing.assert_array_equal(v, want, err_msg=f"{where}: {k}")


def _host_wave(workload):
    """A reference scheduler on the host-segment path with its queries
    admitted, plus one packed fresh wave (numpy) from it."""
    data, queries = _workload(workload)
    ref = JaxScheduler(data, n_slots=SLOTS, wave_size=WAVE, kpr=KPR // 2,
                       stack_capacity=STACK, pattern_capacity=CAP,
                       megastep_depth=6, device_stacks=False, limit=None)
    for q in queries:
        ref.submit(q)
    ref._admit()
    picks = ref._pack_wave()
    return ref, ref._build_wave(picks, ref._wave_kind)


def _t(a):
    return torch.from_numpy(convert.as_int32(np.asarray(a)).copy())


@pytest.mark.parametrize("workload", ["uniform", "trap"])
def test_host_megastep_matches_reference(monkeypatch, workload):
    """run_megastep_mq, every MegaResult lane and the store bank, on a
    packed host wave plus a batch of host-resolved stores."""
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    ref, (fr, us, ph, _lo, valid, slot_v, depth_v, _m) = _host_wave(
        workload)
    rng = np.random.default_rng(5)
    n = 16
    st = (rng.integers(0, SLOTS, n).astype(np.int32),
          rng.integers(0, 4, n).astype(np.int32),
          rng.integers(0, 40, n).astype(np.int32),
          rng.integers(0, 1000, n).astype(np.int32),
          np.zeros(n, np.int32),
          rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32),
          rng.random(n) < 0.7)
    ring, emb_cap = 2 * WAVE * (KPR + 1), 2 * WAVE * KPR
    tb_t = convert.store_bank(ref.tb, "cpu")
    want = jes.run_megastep_mq(
        ref.g, ref.qb, ref.tb, fr, us, ph, valid, slot_v, depth_v, *st,
        np.int32(100), True, kpr=KPR, k_depth=4, capacity=ring,
        emb_cap=emb_cap, backend="jnp")
    got = tes.run_megastep_mq(
        convert.graph_arrays(np.asarray(ref.g.adj_bitmap), "cpu"),
        convert.query_bank(ref.qb, "cpu"), tb_t, _t(fr), _t(us), _t(ph),
        _t(valid), _t(slot_v), _t(depth_v), *map(_t, st), 100, True,
        kpr=KPR, k_depth=4, capacity=ring, emb_cap=emb_cap)
    assert int(got.tail) > WAVE
    _lanes_equal(want, got, f"{workload} megastep")
    _lanes_equal(want.tb, got.tb, f"{workload} megastep store bank")


@pytest.mark.parametrize("workload", ["uniform", "trap"])
def test_single_step_programs_match_reference(monkeypatch, workload):
    """expand_wave_mq, then extract_more_mq on its leftovers and
    assemble_children_mq on its children, lane for lane."""
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    ref, (fr, us, ph, _lo, valid, slot_v, depth_v, _m) = _host_wave(
        workload)
    g_t = convert.graph_arrays(np.asarray(ref.g.adj_bitmap), "cpu")
    qb_t = convert.query_bank(ref.qb, "cpu")
    tb_t = convert.store_bank(ref.tb, "cpu")
    want, tb_j = jes.expand_wave_mq(ref.g, ref.qb, ref.tb, fr, us, ph,
                                    valid, slot_v, depth_v, kpr=2,
                                    backend="jnp")
    got = tes.expand_wave_mq(g_t, qb_t, tb_t, _t(fr), _t(us), _t(ph),
                             _t(valid), _t(slot_v), _t(depth_v), kpr=2)
    _lanes_equal(want, got, f"{workload} expand")
    _lanes_equal(tb_j, tb_t, f"{workload} expand store bank")
    assert int(np.asarray(want.n_leftover).sum()) > 0

    lo = np.asarray(want.leftover)
    want_x = jes.extract_more_mq(tb_j, ph, slot_v, depth_v, lo, kpr=3)
    got_x = tes.extract_more_mq(tb_t, _t(ph), _t(slot_v), _t(depth_v),
                                _t(lo), kpr=3)
    for i, (g, w) in enumerate(zip(got_x, want_x[:7])):
        np.testing.assert_array_equal(
            g.numpy(), convert.as_int32(np.asarray(w)),
            err_msg=f"{workload} extract_more lane {i}")
    _lanes_equal(want_x[7], tb_t, f"{workload} extract_more store bank")

    cv, cvalid = np.asarray(want.child_v), np.asarray(want.child_valid)
    want_a = jes.assemble_children_mq(fr, us, ph, cv, cvalid, depth_v,
                                      np.int32(7))
    got_a = tes.assemble_children_mq(_t(fr), _t(us), _t(ph), _t(cv),
                                     _t(cvalid), _t(depth_v), 7)
    for i, (g, w) in enumerate(zip(got_a, want_a)):
        np.testing.assert_array_equal(
            g.numpy(), convert.as_int32(np.asarray(w)),
            err_msg=f"{workload} assemble lane {i}")
