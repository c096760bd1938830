"""The port's fault-tolerant runtime (``repro_torch.core.faults`` and
the fault half of ``repro_torch.core.vectorized``) on the CPU.

Three parts:

* one port case for each test of ``tests/test_faults.py``, with the same
  assertions, on the port's own generators and sequential oracle;
* a differential test: the same ``FaultPlan`` specs run through the JAX
  ``MatchSession`` and the port's (``device="cpu"``), and the fired
  faults ``(site, kind, crossing)``, the nine fault counters, every
  status, every embedding set and every query's dead-end prunes and
  rows created must be equal, exactly. The JAX side runs with
  ``REPRO_TUNING_DISABLE=1`` so both sides use the built-in knobs;
* the port's own rules: only ``DISPATCH_ERRORS`` is caught (a runtime
  error from the refine propagates out of ``step()`` untouched by the
  retry loop), a real out-of-memory error is recovered without a retry
  on half-updated stacks, and a demoted query still refines through the
  kernel wrapper on the scheduler's device.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import (MatchError, MatchSession, MatchTimeout,
                             QueueFull)
from repro_torch.core import engine_step
from repro_torch.core.backtrack import backtrack_deadend
from repro_torch.core.distributed import (CheckpointCorrupt,
                                          DistributedMatcher)
from repro_torch.core.faults import (DISPATCH_ERRORS, FaultInjected,
                                     FaultPlan, FaultSpec)
from repro_torch.data.graph_gen import (er_labeled_graph, query_set,
                                        trap_graph)

torch.set_num_threads(1)

COUNTERS = ("dispatch_retries", "hangs", "digest_failures", "quarantined",
            "fallbacks", "errors", "flush_drops", "shed",
            "admission_failures")


def embset(embs):
    return set(tuple(np.asarray(e).tolist()) for e in embs)


def sorted_rows(embs):
    return sorted(tuple(np.asarray(e).tolist()) for e in embs)


@pytest.fixture(scope="module")
def workload():
    data = er_labeled_graph(35, 100, 3, seed=11)
    queries = query_set(data, 4, 6, seed=5)
    oracle = [embset(backtrack_deadend(q, data, limit=None).embeddings)
              for q in queries]
    return data, queries, oracle


def session(data, **knobs):
    return MatchSession(data, wave_size=64, n_slots=4, device="cpu",
                        **knobs)


def run_one(data, q, oracle_set, *, expect_status="ok", **knobs):
    """One query through a fresh engine session; asserts terminal status
    and oracle equality, returns (result, fault counters, session)."""
    s = session(data, **knobs)
    h = s.submit(q, limit=None)
    r = h.result()
    f = s.scheduler.scheduler_stats()["faults"]
    assert r.status == expect_status
    if expect_status == "ok":
        assert embset(r.embeddings) == oracle_set
    return r, f, s


# ----------------------------------------------------------------------
# the fault plan itself
# ----------------------------------------------------------------------
def test_fault_plan_is_deterministic():
    plan = FaultPlan([FaultSpec("dispatch", "exception", at=2, times=2),
                      FaultSpec("flush", "exception", at=1)])
    hits = [plan.poke("dispatch") is not None for _ in range(5)]
    assert hits == [False, True, True, False, False]
    assert plan.poke("flush") is not None
    assert [(s, k, n) for s, k, n, _ in plan.fired] == \
        [("dispatch", "exception", 2), ("dispatch", "exception", 3),
         ("flush", "exception", 1)]
    plan.reset()
    assert plan.peek("dispatch") == 0 and plan.fired == []
    assert [plan.poke("dispatch") is not None for _ in range(5)] == hits


def test_fault_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec("nonsense", "exception")
    with pytest.raises(ValueError):
        FaultSpec("dispatch", "shard_loss")     # wrong kind for site
    with pytest.raises(ValueError):
        FaultSpec("dispatch", "exception", at=0)


# ----------------------------------------------------------------------
# dispatch retry / watchdog / digest quarantine / fallback
# ----------------------------------------------------------------------
def test_dispatch_exception_is_retried(workload):
    data, queries, oracle = workload
    plan = FaultPlan([FaultSpec("dispatch", "exception", at=2)])
    _, f, _ = run_one(data, queries[0], oracle[0], faults=plan)
    assert f["dispatch_retries"] >= 1
    assert f["fallbacks"] == 0 and f["errors"] == 0


def test_retry_exhaustion_demotes_to_host(workload):
    data, queries, oracle = workload
    plan = FaultPlan([FaultSpec("dispatch", "exception", at=2, times=5)])
    r, f, _ = run_one(data, queries[0], oracle[0], faults=plan)
    assert f["dispatch_retries"] == 2          # budget fully spent
    assert f["quarantined"] >= 1 and f["fallbacks"] >= 1
    assert r.stats.fallback


def test_hang_fires_watchdog_then_fallback(workload):
    data, queries, oracle = workload
    plan = FaultPlan([FaultSpec("dispatch", "hang", at=2)])
    _, f, _ = run_one(data, queries[0], oracle[0], faults=plan)
    assert f["hangs"] >= 1 and f["fallbacks"] >= 1


def test_digest_corruption_is_caught_never_absorbed(workload):
    data, queries, oracle = workload
    plan = FaultPlan([FaultSpec("digest", "corrupt", at=1)])
    _, f, _ = run_one(data, queries[0], oracle[0], faults=plan)
    assert f["digest_failures"] >= 1
    assert f["quarantined"] >= 1 and f["fallbacks"] >= 1


def test_digest_overflow_is_caught(workload):
    data, queries, oracle = workload
    plan = FaultPlan([FaultSpec("digest", "overflow", at=1)])
    _, f, _ = run_one(data, queries[0], oracle[0], faults=plan)
    assert f["digest_failures"] >= 1


def test_corrupt_digest_only_hits_target_slot(workload):
    data, queries, oracle = workload
    qa, qb = queries[0], queries[1]

    def run(plan):
        s = session(data, faults=plan)
        ha = s.submit(qa, limit=None)
        hb = s.submit(qb, limit=None)
        return ha.result(), hb.result(), s

    ra0, rb0, _ = run(None)                        # fault-free baseline
    plan = FaultPlan([FaultSpec("digest", "corrupt", at=1, slot=0)])
    ra1, rb1, s = run(plan)
    assert s.scheduler.scheduler_stats()["faults"]["digest_failures"] >= 1
    assert ra1.status == "ok" and rb1.status == "ok"
    assert embset(ra1.embeddings) == oracle[0]
    assert sorted_rows(rb1.embeddings) == sorted_rows(rb0.embeddings)


def test_error_status_when_fallback_disabled(workload):
    data, queries, oracle = workload
    plan = FaultPlan([FaultSpec("digest", "corrupt", at=1)])
    s = session(data, faults=plan, fallback_on_failure=False)
    h = s.submit(queries[0], limit=None)
    r = h.result()
    assert r.status == "error" and r.aborted
    assert h.done()
    assert isinstance(h.error, MatchError)
    assert "digest validation failed" in str(h.error)
    assert s.scheduler.scheduler_stats()["faults"]["errors"] == 1


def test_admission_fault_errors_the_request(workload):
    data, queries, _ = workload
    plan = FaultPlan([FaultSpec("admission", "exception", at=1)])
    s = session(data, faults=plan)
    h = s.submit(queries[0], limit=None)
    assert h.result().status == "error"
    assert s.scheduler.scheduler_stats()["faults"][
        "admission_failures"] == 1


def test_flush_fault_drops_patterns_soundly():
    q, data = trap_graph(n_b=12, n_c=12, n_good=2, tail_len=2, seed=0)
    oracle = embset(backtrack_deadend(q, data, limit=None).embeddings)
    plan = FaultPlan([FaultSpec("flush", "exception", at=1)])
    s = session(data, megastep_depth=1, device_stacks=False, faults=plan)
    r = s.submit(q, limit=None).result()
    assert r.status == "ok" and embset(r.embeddings) == oracle
    assert s.scheduler.scheduler_stats()["faults"]["flush_drops"] >= 1


def test_host_megastep_path_faults(workload):
    data, queries, oracle = workload
    knobs = dict(device_stacks=False, adaptive_prune_threshold=1.0)
    plan = FaultPlan([FaultSpec("dispatch", "exception", at=1)])
    _, f, _ = run_one(data, queries[0], oracle[0], faults=plan, **knobs)
    assert f["dispatch_retries"] >= 1
    plan = FaultPlan([FaultSpec("dispatch", "hang", at=1)])
    _, f, _ = run_one(data, queries[0], oracle[0], faults=plan, **knobs)
    assert f["hangs"] >= 1


def test_fault_hooks_are_inert_when_disabled(workload):
    data, queries, oracle = workload
    _, f, _ = run_one(data, queries[0], oracle[0])
    assert sorted(f) == sorted(COUNTERS)
    assert all(v == 0 for v in f.values())


# ----------------------------------------------------------------------
# typed timeout, shedding, checkpoint validation, shard loss
# ----------------------------------------------------------------------
def test_result_timeout_raises_typed_not_blocks(workload):
    data, queries, oracle = workload
    s = session(data)
    h = s.submit(queries[0], limit=None)
    with pytest.raises(MatchTimeout):
        h.result(timeout=0.0)
    assert not h.done()
    r = h.result()
    assert r.status == "ok" and embset(r.embeddings) == oracle[0]
    assert h.result(timeout=0.0) is r


def test_overload_shedding_drops_lowest_priority(workload):
    data, queries, oracle = workload
    s = MatchSession(data, wave_size=64, n_slots=1, max_queue=2,
                     shed_policy="shed_lowest", device="cpu")
    handles = [s.submit(q, limit=None, priority=i % 3)
               for i, q in enumerate(queries)]
    results = [h.result() for h in handles]
    statuses = [r.status for r in results]
    assert statuses.count("shed") >= 1
    shed_prio = [i % 3 for i, st in enumerate(statuses) if st == "shed"]
    ok_prio = [i % 3 for i, st in enumerate(statuses) if st == "ok"]
    assert max(shed_prio) <= min(ok_prio)
    for i, r in enumerate(results):
        if r.status == "ok":
            assert embset(r.embeddings) == oracle[i]
    f = s.scheduler.scheduler_stats()["faults"]
    assert f["shed"] == statuses.count("shed")
    s2 = MatchSession(data, wave_size=64, n_slots=1, max_queue=1,
                      device="cpu")
    with pytest.raises(QueueFull):
        for q in queries:
            s2.submit(q, limit=None)


def test_server_tallies_shed_and_errors(workload):
    from repro_torch.serving.query_server import QueryServer
    data, queries, _ = workload
    plan = FaultPlan([FaultSpec("admission", "exception", at=1)])
    srv = QueryServer(data, backend="engine", wave_size=64, n_slots=4,
                      faults=plan, fallback_on_failure=False, device="cpu")
    srv.submit_batch(queries[:2])
    rep = srv.slo_report()
    assert rep["errors"] == 1 and rep["shed"] == 0


def test_checkpoint_corrupt_truncated_archive(tmp_path):
    (tmp_path / "state.npz").write_bytes(b"PK\x03\x04 not a real zip")
    with pytest.raises(CheckpointCorrupt, match="unreadable"):
        DistributedMatcher.load_state(str(tmp_path))


def test_checkpoint_corrupt_names_the_bad_field(tmp_path):
    np.savez_compressed(tmp_path / "state.npz",
                        version=np.int64(3), n_shards=np.int64(2))
    with pytest.raises(CheckpointCorrupt, match="phi_floor"):
        DistributedMatcher.load_state(str(tmp_path))
    np.savez_compressed(
        tmp_path / "state.npz", version=np.int64(99),
        n_shards=np.int64(2), phi_floor=np.int64(1),
        pending_roots=np.zeros(0, np.int32),
        embeddings=np.zeros((0, 0), np.int32))
    with pytest.raises(CheckpointCorrupt, match="version"):
        DistributedMatcher.load_state(str(tmp_path))
    np.savez_compressed(
        tmp_path / "state.npz", version=np.int64(3),
        n_shards=np.int64(2), phi_floor=np.int64(1),
        pending_roots=np.zeros((2, 2), np.int32),
        embeddings=np.zeros((0, 0), np.int32))
    with pytest.raises(CheckpointCorrupt, match="pending_roots"):
        DistributedMatcher.load_state(str(tmp_path))
    np.savez_compressed(
        tmp_path / "state.npz", version=np.int64(3),
        n_shards=np.int64(2), phi_floor=np.int64(1),
        pending_roots=np.zeros(0, np.int32),
        embeddings=np.zeros((0, 0), np.int32),
        delta_pos=np.zeros(3, np.int32), delta_v=np.zeros(3, np.int32),
        delta_phi=np.zeros(3, np.int32), delta_mu=np.zeros(3, np.int32),
        delta_mask=np.zeros(2, np.uint64),
        delta_hits=np.zeros(3, np.int64))
    with pytest.raises(CheckpointCorrupt, match="delta_mask"):
        DistributedMatcher.load_state(str(tmp_path))


def test_checkpoint_valid_roundtrip_still_loads(tmp_path, workload):
    data, queries, oracle = workload
    m = DistributedMatcher(data, n_shards=2, wave_size=64, device="cpu")
    out = m.match(queries[0], limit=None, checkpoint_dir=str(tmp_path))
    assert embset(out.embeddings) == oracle[0]
    ck = DistributedMatcher.load_state(str(tmp_path))
    assert ck is not None and ck.version == 3
    assert len(ck.pending_roots) == 0


def test_shard_loss_recovers_on_survivors(tmp_path, workload):
    data, queries, oracle = workload
    ref = DistributedMatcher(data, n_shards=4, wave_size=64,
                             device="cpu").match(queries[0], limit=None)
    plan = FaultPlan([FaultSpec("shard", "shard_loss", at=2)])
    m = DistributedMatcher(data, n_shards=4, wave_size=64,
                           micro_checkpoint_every=1, faults=plan,
                           device="cpu")
    out = m.match(queries[0], limit=None, checkpoint_dir=str(tmp_path))
    assert m.n_shards == 3
    assert len(plan.fired) == 1
    assert embset(out.embeddings) == embset(ref.embeddings) == oracle[0]


def test_checkpoint_save_fault_keeps_previous_snapshot(tmp_path,
                                                       workload):
    data, queries, oracle = workload
    plan = FaultPlan([FaultSpec("checkpoint", "exception", at=1,
                                times=100)])
    m = DistributedMatcher(data, n_shards=2, wave_size=64,
                           micro_checkpoint_every=1, faults=plan,
                           device="cpu")
    out = m.match(queries[0], limit=None, checkpoint_dir=str(tmp_path))
    assert embset(out.embeddings) == oracle[0]
    assert plan.peek("checkpoint") >= 1
    assert not (tmp_path / "state.npz").exists()


# ----------------------------------------------------------------------
# differential: the same plan through the JAX package and the port
# ----------------------------------------------------------------------
HOST_MEGA = dict(device_stacks=False, adaptive_prune_threshold=1.0)
PLANS = {
    "dispatch-exception": ("er", [("dispatch", "exception", dict(at=2))],
                           {}),
    "retry-exhaustion": ("er", [("dispatch", "exception",
                                 dict(at=2, times=3))], {}),
    "hang": ("er", [("dispatch", "hang", dict(at=2))], {}),
    "digest-corrupt": ("er", [("digest", "corrupt", dict(at=1, slot=1))],
                       {}),
    "digest-overflow": ("er", [("digest", "overflow", dict(at=2))], {}),
    "flush-drop": ("trap", [("flush", "exception", dict(at=1))],
                   dict(megastep_depth=1, device_stacks=False)),
    "admission": ("er", [("admission", "exception", dict(at=2))], {}),
    "device-stacks-off": ("trap", [("dispatch", "exception", dict(at=1)),
                                   ("dispatch", "hang", dict(at=3)),
                                   ("flush", "exception", dict(at=2))],
                          HOST_MEGA),
    "hang-and-corrupt": ("trap", [("dispatch", "hang", dict(at=3)),
                                  ("digest", "corrupt",
                                   dict(at=2, slot=2))], {}),
    # demotions after the query found rows: the replay must not count
    # them twice
    "hang-after-rows": ("er", [("dispatch", "hang", dict(at=4))], {}),
    "corrupt-after-rows": ("trap", [("digest", "corrupt", dict(at=7))],
                           {}),
    "host-hang-after-rows": ("trap", [("dispatch", "hang", dict(at=4))],
                             HOST_MEGA),
    "watchdog-deadline": ("er", [], dict(dispatch_timeout_s=1e-9)),
    "fallback-off": ("er", [("digest", "corrupt", dict(at=1))],
                     dict(fallback_on_failure=False)),
}


def _jax_workload(name, n_queries=3):
    from repro.data.graph_gen import er_labeled_graph as jer
    from repro.data.graph_gen import query_set as jqs
    from repro.data.graph_gen import trap_graph as jtrap
    if name == "er":
        data = jer(35, 100, 3, seed=11)
        return data, jqs(data, 4, 6, seed=5)[:n_queries]
    q, data = jtrap(n_b=12, n_c=12, n_good=2, tail_len=2, seed=0)
    return data, [q] * 3


def _run_plan(session_cls, plan, data, queries, knobs, **extra):
    s = session_cls(data, wave_size=64, n_slots=4, faults=plan, **knobs,
                    **extra)
    results = [h.result() for h in [s.submit(q, limit=None)
                                    for q in queries]]
    return {
        "fired": [(site, kind, n) for site, kind, n, _ in plan.fired],
        "counters": s.scheduler.scheduler_stats()["faults"],
        "statuses": [r.status for r in results],
        "embeddings": [embset(r.embeddings) for r in results],
        "found": [len(r.embeddings) for r in results],
        "fallback": [bool(r.stats.fallback) for r in results],
        "counts": [(r.stats.deadend_prunes, r.stats.rows_created)
                   for r in results]}


@pytest.mark.parametrize("plan_name", list(PLANS))
def test_fault_plan_matches_the_reference(monkeypatch, plan_name):
    from repro.api import MatchSession as JaxSession
    from repro.core import faults as jfaults
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    wl, specs, knobs = PLANS[plan_name]
    data, queries = _jax_workload(wl)
    want = _run_plan(JaxSession, jfaults.FaultPlan(
        [jfaults.FaultSpec(site, kind, **kw) for site, kind, kw in specs]),
        data, queries, knobs)
    got = _run_plan(MatchSession, FaultPlan(
        [FaultSpec(site, kind, **kw) for site, kind, kw in specs]),
        data, queries, knobs, device="cpu")
    assert got["fired"] == want["fired"]
    assert got["counters"] == want["counters"]
    assert got["statuses"] == want["statuses"]
    assert got["embeddings"] == want["embeddings"]
    assert got["found"] == want["found"] == [len(e) for e in
                                             got["embeddings"]]
    assert got["fallback"] == want["fallback"]
    assert got["counts"] == want["counts"]
    # every plan lands; a plan with specs fires each of them
    assert {(s, k) for s, k, _ in got["fired"]} == \
        {(s, k) for s, k, _ in specs}
    assert any(got["counters"].values())


# ----------------------------------------------------------------------
# the port's own rules
# ----------------------------------------------------------------------
def test_dispatch_errors_are_the_injected_fault_and_oom_only():
    assert DISPATCH_ERRORS == (FaultInjected, torch.OutOfMemoryError)


@pytest.mark.parametrize("knobs", [{}, HOST_MEGA],
                         ids=["device-stacks", "host-megastep"])
def test_runtime_error_from_the_refine_propagates(monkeypatch, workload,
                                                  knobs):
    """A CUDA fault, a build failure or any other runtime error is never
    retried or demoted: it leaves ``step()`` as raised, and the retry
    loop has not counted it."""
    data, queries, _ = workload

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(engine_step, "refine_bitmap_rows", broken)
    s = session(data, faults=FaultPlan([]), **knobs)
    s.submit(queries[0], limit=None)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        s.run()
    f = s.scheduler.scheduler_stats()["faults"]
    assert f["dispatch_retries"] == 0
    assert f["quarantined"] == 0 and f["fallbacks"] == 0


def _oom_once(monkeypatch):
    real = engine_step.refine_bitmap_rows
    state = {"raised": 0, "calls": 0}

    def flaky(*args, **kwargs):
        state["calls"] += 1
        if not state["raised"]:
            state["raised"] = 1
            raise torch.OutOfMemoryError("CUDA out of memory")
        return real(*args, **kwargs)

    monkeypatch.setattr(engine_step, "refine_bitmap_rows", flaky)
    return state


def test_oom_on_the_device_stacks_quarantines_at_once(monkeypatch,
                                                      workload):
    """The stack bank may be half-updated when an out-of-memory error
    strikes, so the dispatch is not re-run on it: its queries replay on
    the degraded path, still exact."""
    data, queries, oracle = workload
    state = _oom_once(monkeypatch)
    r, f, s = run_one(data, queries[0], oracle[0])
    assert state["raised"] == 1
    assert f["dispatch_retries"] == 0
    assert f["quarantined"] == 1 and f["fallbacks"] == 1
    assert r.stats.fallback


def test_oom_on_the_host_megastep_is_retried(monkeypatch, workload):
    """A host megastep touches only the Δ bank in place: it is rebuilt
    (patterns only prune) and the dispatch retried, no demotion."""
    data, queries, oracle = workload
    state = _oom_once(monkeypatch)
    r, f, _ = run_one(data, queries[0], oracle[0], **HOST_MEGA)
    assert state["raised"] == 1
    assert f["dispatch_retries"] == 1
    assert f["quarantined"] == 0 and not r.stats.fallback


def test_demoted_query_still_refines_on_the_scheduler_device(monkeypatch,
                                                             workload):
    """"Host" in the degraded path means host-scheduled: the replay's
    refines go through the kernel wrapper, and every bank stays on the
    scheduler's device."""
    data, queries, oracle = workload
    real = engine_step.refine_bitmap_rows
    calls = []

    def counted(adj, cand, *args, **kwargs):
        calls.append(cand.device)
        return real(adj, cand, *args, **kwargs)

    monkeypatch.setattr(engine_step, "refine_bitmap_rows", counted)
    plan = FaultPlan([FaultSpec("dispatch", "hang", at=1)])
    s = session(data, faults=plan)
    h = s.submit(queries[0], limit=None)
    s.step()                       # the hung dispatch goes out
    n_before = len(calls)
    r = h.result()
    assert r.stats.fallback and embset(r.embeddings) == oracle[0]
    assert len(calls) > n_before
    sched = s.scheduler
    assert set(calls) == {sched.device}
    assert sched.tb.valid.device == sched.device
    assert sched.sb.state.device == sched.device


def test_exhausted_host_megastep_dispatch_still_completes():
    """The first host megastep failing for good leaves only queued
    replays; ``step()`` counts that as progress, so the session runs
    them instead of reporting itself idle."""
    q, data = trap_graph(n_b=12, n_c=12, n_good=2, tail_len=2, seed=0)
    oracle = embset(backtrack_deadend(q, data, limit=None).embeddings)
    plan = FaultPlan([FaultSpec("dispatch", "exception", at=2, times=3)])
    s = session(data, faults=plan, **HOST_MEGA)
    results = [h.result() for h in [s.submit(q, limit=None)
                                    for _ in range(3)]]
    assert all(r.status == "ok" and embset(r.embeddings) == oracle
               for r in results)
    f = s.scheduler.scheduler_stats()["faults"]
    assert f["dispatch_retries"] == 2 and f["fallbacks"] == 1


def test_stack_rebuild_quarantines_queries_admitted_meanwhile(
        monkeypatch):
    """Two slots, six queries, wave 16, a hang at the fourth dispatch: a
    query admitted while the hung dispatch was in flight has its stack
    in the bank the watchdog rebuilds. The port quarantines it too and
    every set equals the oracle; the reference quarantines only the hung
    dispatch's queries and returns that query with rows missing (a
    disagreement inside the reference, pinned here)."""
    from repro.api import MatchSession as JaxSession
    from repro.core import faults as jfaults
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    data, queries = _jax_workload("er", n_queries=6)
    oracle = [embset(backtrack_deadend(q, data, limit=None).embeddings)
              for q in queries]

    def run(session_cls, plan, **extra):
        s = session_cls(data, wave_size=16, n_slots=2, faults=plan,
                        **extra)
        results = [h.result() for h in [s.submit(q, limit=None)
                                        for q in queries]]
        return results, s.scheduler.scheduler_stats()["faults"]

    got, f = run(MatchSession, FaultPlan([FaultSpec("dispatch", "hang",
                                                    at=4)]), device="cpu")
    assert all(r.status == "ok" for r in got)
    assert [embset(r.embeddings) for r in got] == oracle
    assert f["hangs"] == 1 and f["quarantined"] == 2
    want, jf = run(JaxSession, jfaults.FaultPlan(
        [jfaults.FaultSpec("dispatch", "hang", at=4)]))
    assert jf["quarantined"] == 1
    assert [i for i, r in enumerate(want)
            if embset(r.embeddings) != oracle[i]] == [2]
