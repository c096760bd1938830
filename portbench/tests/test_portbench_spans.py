"""The program's spans as the benchmark reads them: the idle-by-span
reduction of an exported trace (stand-in events and a real CPU profile),
the trace reduction left as it was by the program's ranges, and the four
readers of the spans on a synthetic context."""
import gzip
import json
import sys

import pytest
import torch

from portbench import harness, program_spans, trace
from portbench.program_spans import PREFIX, idle_by_span
from portbench.tests.test_portbench_benchmark import context
from portbench.tests.test_portbench_trace import CUDA, Ev
from portbench.tests.test_portbench_trace import events as trace_events

HOST, DEV = (100, 1), (0, 7)


def x(name, a, b, where=HOST, cat="cpu_op"):
    """A Chrome trace complete event over [a, b) ns."""
    return {"ph": "X", "name": name, "cat": cat, "pid": where[0],
            "tid": where[1], "ts": a / 1000, "dur": (b - a) / 1000}


def chrome_events():
    k = dict(where=DEV, cat="kernel")
    return [
        x(trace.WINDOW, 0, 1000, cat="user_annotation"),
        x(trace.WINDOW, 100, 900, where=DEV, cat="gpu_user_annotation"),
        x("submit_async", 0, 400, cat="user_annotation"),
        x("submit_async", 0, 400, where=DEV, cat="gpu_user_annotation"),
        x(PREFIX + "submit", 10, 390),
        x(PREFIX + "submit.candidates", 20, 200),
        x(PREFIX + "submit.candidates.nlf", 50, 150),
        x(PREFIX + "submit.pack", 250, 300),
        x("step", 400, 1000, cat="user_annotation"),
        x(PREFIX + "step", 410, 990),
        x(PREFIX + "step.dispatch", 420, 800),
        x(PREFIX + "step.dispatch.readback", 700, 800),
        x("aten::index_put_", 430, 600),
        x("k_a", 100, 250, **k),
        x("k_b", 600, 750, **k),
        x("Memcpy DtoH", 950, 1100, where=DEV, cat="gpu_memcpy"),
        x("count", 0, 1000, where=(0, 9), cat="kernel"),   # another stream
        x(PREFIX + "step", 0, 1000, where=(100, 2)),      # another thread
        {"ph": "s", "name": "ac2g", "pid": 0, "tid": 7, "ts": 0.1},
    ]


def test_idle_is_split_at_the_range_boundaries():
    idle = idle_by_span(chrome_events())
    assert idle.window_s == pytest.approx(1000e-9)
    # busy: [100, 250) + [600, 750) + [950, 1000)
    assert idle.busy_s == pytest.approx(350e-9)
    # idle [0, 100), [250, 600), [750, 950), each split by the innermost
    # range open over it
    want = {"none": 10 + 20, "submit": 10 + 90, "submit.candidates": 30,
            "submit.candidates.nlf": 50, "submit.pack": 50,
            "step": 10 + 150, "step.dispatch": 180,
            "step.dispatch.readback": 50}
    assert idle.by_span == pytest.approx({k: v * 1e-9
                                          for k, v in want.items()})
    assert sum(idle.by_span.values()) == pytest.approx(
        idle.window_s - idle.busy_s)
    assert idle.under("submit") == pytest.approx(230e-9)
    assert idle.under("step.dispatch") == pytest.approx(230e-9)


def test_a_trace_without_the_window_range_is_refused():
    with pytest.raises(ValueError):
        idle_by_span([e for e in chrome_events()
                      if e["name"] != trace.WINDOW])


def test_the_program_ranges_leave_the_trace_reduction_as_it_was():
    """The program's ranges are op ranges on the host thread: with them
    every field of the reduction is what it is without them."""
    ranges = [Ev(PREFIX + "step", 0, 700), Ev(PREFIX + "step.dispatch",
                                              80, 650),
              Ev(PREFIX + "step.dispatch.readback", 400, 640),
              Ev(PREFIX + "submit", 710, 990)]
    a = trace.reduce_events(trace_events(), {CUDA})
    b = trace.reduce_events(trace_events() + ranges, {CUDA})
    assert vars(a) == vars(b)


def test_the_prefix_is_the_programs():
    from repro_torch.core import spans
    assert program_spans.PREFIX == spans.PREFIX


def test_a_real_profile_of_the_program(tmp_path):
    """A tiny serve under the CPU profiler, exported as the harness
    exports: no device activity, so all of the window is idle, split by
    the program's ranges."""
    from repro_torch.data.graph_gen import er_labeled_graph, query_set
    from repro_torch.serving import QueryServer
    data = er_labeled_graph(40, 120, 3, seed=6)
    queries = query_set(data, 5, 3, seed=3)
    srv = QueryServer(data, backend="engine", device="cpu", n_slots=4,
                      wave_size=32, stack_capacity=256, limit=None)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            hs = []
            for q in queries:
                with torch.profiler.record_function("submit_async"):
                    hs.append(srv.submit_async(q))
            while not all(h.done() for h in hs):
                with torch.profiler.record_function("step"):
                    srv.step()
    path = tmp_path / "t.json.gz"
    prof.export_chrome_trace(str(path))
    with gzip.open(path, "rt") as f:
        idle = idle_by_span(json.load(f)["traceEvents"])
    assert idle.busy_s == 0
    assert sum(idle.by_span.values()) == pytest.approx(idle.window_s)
    for name in ("submit", "submit.candidates.cfl", "step.admit",
                 "step.dispatch.readback"):
        assert idle.by_span[name] > 0, name
    assert idle.under("submit") < idle.window_s


def spans_ctx(**over):
    table0 = {"submit": {"n": 10, "s": 0.5, "self_s": 0.1},
              "submit.candidates": {"n": 10, "s": 0.3, "self_s": 0.3},
              "step.dispatch.readback": {"n": 90, "s": 0.2, "self_s": 0.2}}
    table1 = {"submit": {"n": 30, "s": 1.5, "self_s": 0.3},
              "submit.candidates": {"n": 30, "s": 1.2, "self_s": 1.2},
              "step.dispatch.readback": {"n": 590, "s": 1.2, "self_s": 1.2},
              "step.retire.readback": {"n": 100, "s": 0.3, "self_s": 0.3},
              "step": {"n": 100, "s": 9.0, "self_s": 1.0}}
    ctx = context()
    ctx.counters0 = {**ctx.counters0, "spans": table0}
    ctx.counters1 = {**ctx.counters1, "spans": table1}
    for k, v in over.items():
        setattr(ctx, k, v)
    return ctx


def test_the_span_readers_on_a_synthetic_context():
    read = harness.read_metric
    assert read("submit_ms_per_query", spans_ctx()) == pytest.approx(
        1e3 * 1.0 / 20)
    assert read("submit_candidates_pct", spans_ctx()) == pytest.approx(
        100 * 0.9 / 1.0)
    # (1.0 + 0.3) s of readbacks over 500 iterations
    assert read("readback_ms_per_iteration", spans_ctx()) == \
        pytest.approx(1e3 * 1.3 / 500)
    # no submit (or no iteration) in the window: nothing to divide by
    idle = spans_ctx()
    idle.counters1 = {**idle.counters1, "loop_iterations": 100,
                      "spans": idle.counters0["spans"]}
    for name in ("submit_ms_per_query", "submit_candidates_pct",
                 "readback_ms_per_iteration"):
        assert read(name, idle) is None, name
    # a program without a span table reads nothing, and does not raise
    for name in ("submit_ms_per_query", "submit_candidates_pct",
                 "readback_ms_per_iteration"):
        assert read(name, context()) is None, name


def test_the_idle_in_submit_reader_reads_the_runs_trace(tmp_path,
                                                        monkeypatch):
    runs = tmp_path / "portbench" / ".runs"
    runs.mkdir(parents=True)
    with gzip.open(runs / "trace-cell-4000000001.json.gz", "wt") as f:
        json.dump({"traceEvents": chrome_events()}, f)
    monkeypatch.setattr(program_spans, "ROOT", tmp_path)
    ctx = spans_ctx()
    ctx.cell = harness.Cell("cell", 1, {}, {}, [], [])
    read = lambda: harness.read_metric("device_idle_in_submit_pct", ctx)
    monkeypatch.setattr(sys, "argv", ["portbench/run.py", "--workload",
                                      "cell", "--seed", "4000000001"])
    assert read() == pytest.approx(100 * 230e-9 / 1000e-9)
    # another seed's run, or no traced part: nothing to read
    monkeypatch.setattr(sys, "argv", ["portbench/run.py", "--seed=5"])
    assert read() is None
    ctx.profile = None
    assert read() is None
    # a trace without the program's ranges (an older commit): nothing
    monkeypatch.setattr(sys, "argv", ["run.py", "--seed", "6"])
    with gzip.open(runs / "trace-cell-6.json.gz", "wt") as f:
        json.dump({"traceEvents": [e for e in chrome_events()
                                   if not e["name"].startswith(PREFIX)]}, f)
    ctx.profile = context().profile
    assert read() is None
