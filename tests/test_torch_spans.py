"""The port's span table (``repro_torch.core.spans``) and the spans of the
served path, on the CPU.

The table's arithmetic runs on a stub clock. A tiny serve through
``QueryServer(backend="engine", device="cpu")`` then shows what the
scheduler records: no profiler range entered while no profiler runs,
the ``repro_torch.*`` ranges (op ranges, not user annotations, so the
profiler copies none onto a device timeline) nested as their names say
while one does, one ``submit`` span per submit, the ``iterations``
counter behind both ``scheduler.timing`` and ``loop_iterations``, and
the front door's ``nlf_table_builds`` and ``cfl_rows`` counters, on each
of the scheduler's three schedules.
"""
import json

import pytest
import torch

from repro_torch.core import spans as spans_mod
from repro_torch.core.backtrack import backtrack_deadend
from repro_torch.core.spans import PREFIX, Spans
from repro_torch.data.graph_gen import er_labeled_graph, query_set
from repro_torch.serving import QueryServer

torch.set_num_threads(1)

KNOBS = dict(n_slots=4, wave_size=32, stack_capacity=256,
             pattern_capacity=64, limit=None)
# the scheduler's schedules: device stacks, the host megastep, single step
SCHEDULES = {"device": {}, "host-megastep": {"device_stacks": False},
             "single-step": {"megastep_depth": 1}}
REMOVED = ("dispatch_time_s", "device_sync_time_s", "host_time_s",
           "host_admission_time_s", "host_digest_time_s",
           "host_retirement_time_s", "host_flush_time_s", "loop_readbacks",
           "loop_readback_time_s")


def _emb(embs):
    return {tuple(int(x) for x in e) for e in embs}


def _serve(**knobs):
    """Serve five queries as the benchmark does: submit all, then step
    until each handle is done. ``(server, queries, results, steps)``."""
    data = er_labeled_graph(40, 120, 3, seed=6)
    queries = query_set(data, 5, 5, seed=3)
    srv = QueryServer(data, backend="engine", device="cpu",
                      **{**KNOBS, **knobs})
    handles = [srv.submit_async(q) for q in queries]
    steps = 0
    while not all(h.done() for h in handles):
        srv.step()
        steps += 1
    results = [h.result() for h in handles]
    for q, r in zip(queries, results):
        assert _emb(r.embeddings) == _emb(
            backtrack_deadend(q, data, limit=None).embeddings)
    return srv, queries, results, steps


def test_nesting_and_self_time_on_a_stub_clock():
    ticks = iter([0, 1, 3, 4, 5, 6, 7, 9, 10, 12, 20, 21])
    sp = Spans(clock=lambda: next(ticks))
    with sp.span("a"):                       # 0 .. 12
        with sp.span("b"):                   # 1 .. 3
            pass
        with sp.span("b"):                   # 4 .. 5
            pass
        with sp.span("c"):                   # 6 .. 10
            with sp.span("d"):               # 7 .. 9
                pass
    with pytest.raises(KeyError):
        with sp.span("b"):                   # 20 .. 21, left by a raise
            raise KeyError("x")
    sp.count("iterations")
    sp.count("rows")
    sp.count("rows")
    assert sp.snapshot() == {
        "a": {"n": 1, "s": 12, "self_s": 12 - 3 - 4},
        "a.b": {"n": 2, "s": 3, "self_s": 3},
        "a.c": {"n": 1, "s": 4, "self_s": 2},
        "a.c.d": {"n": 1, "s": 2, "self_s": 2},
        "b": {"n": 1, "s": 1, "self_s": 1}}
    assert sp.counters == {"iterations": 1, "rows": 2}
    assert sp._open == []


def test_no_profiler_range_is_entered_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was entered")
    monkeypatch.setattr(spans_mod, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    srv, queries, _, _ = _serve()
    spans = srv.scheduler.scheduler_stats()["spans"]
    assert spans["submit"]["n"] == len(queries)
    assert spans["step.dispatch.readback"]["n"] > 0


def test_a_profiled_serve_records_the_program_ranges():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        srv, queries, results, _ = _serve()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name().startswith(PREFIX)]
    by = {}
    for e in ev:
        by.setdefault(e.name()[len(PREFIX):], []).append(e)
    submits = by["submit"]
    assert len(submits) == len(queries)
    assert sorted(e.kwinputs()["qid"] for e in submits) == sorted(
        r.query_id for r in results)
    assert not any(e.is_user_annotation() for e in ev)

    def inside(child, parents):
        return any(p.start_thread_id() == child.start_thread_id()
                   and p.start_ns() <= child.start_ns()
                   and child.end_ns() <= p.end_ns() for p in parents)

    for leaf in ("ldf", "nlf", "cfl"):
        kids = by[f"submit.candidates.{leaf}"]
        assert len(kids) == len(queries)
        assert all(inside(k, by["submit.candidates"]) for k in kids)
    assert all(inside(k, submits) for k in by["submit.candidates"])
    assert all(inside(k, by["step"]) for k in by["step.admit"])
    assert all(inside(k, by["step.dispatch"])
               for k in by["step.dispatch.readback"])
    # the table saw what the trace saw
    table = srv.scheduler.scheduler_stats()["spans"]
    assert table["submit"]["n"] == len(queries)
    for name, evs in by.items():
        assert table[name]["n"] == len(evs), name


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_the_span_table_behind_scheduler_stats(schedule):
    srv, queries, _, steps = _serve(**SCHEDULES[schedule])
    sched = srv.scheduler
    rep = srv.slo_report()
    spans = rep["spans"]
    json.dumps(spans)
    assert spans["submit"]["n"] == len(queries)
    assert spans["step"]["n"] == steps
    for name, v in spans.items():
        assert 0 <= v["self_s"] <= v["s"] + 1e-9, name
        parent = name.rpartition(".")[0]
        assert not parent or parent in spans, name
    # the counter is one store: the table's, scheduler.timing and the
    # stats' loop_iterations
    assert sched.timing is sched.spans.counters
    assert rep["loop_iterations"] == sched.timing["iterations"] > 0
    # the front door's counters: the data graph's neighbor-label table
    # built once for all submits, and the rows CFL's sweeps reduced
    assert sched.timing["nlf_table_builds"] == 1
    assert sched.timing["cfl_rows"] > 0
    assert rep["counters"] == sched.timing
    readbacks = {k for k in spans if k.endswith(".readback")}
    if schedule == "single-step":
        assert readbacks == {"step.retire.readback"}
    else:
        assert {"step.dispatch.readback",
                "step.retire.readback"} <= readbacks
    assert not set(REMOVED) & set(rep)
    assert not [k for k in vars(sched) if k.startswith("t_")
                and k.endswith("_s")]
