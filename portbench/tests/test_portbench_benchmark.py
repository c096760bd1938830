"""``BENCHMARK.json`` against the contract's shape, every cell found by
name, and the per-layer readers on a synthetic context."""
import json
import re
import types

import numpy as np
import pytest

from portbench import harness, stats
from portbench.tests.tiny import HERE, REPO, make_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E = {"qps", "latency_p95_ms", "ttfe_p95_ms", "setup_s"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_have_exactly_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer")
               for m in BENCH[k])


def test_end_to_end_metrics_and_what_each_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) <= E2E and "setup_s" in e2e
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(workload):
    cell = harness.load_cell(workload)
    w = {x["name"]: x for x in BENCH["workloads"]}[workload]
    assert cell.config["name"] == w["config"]
    assert cell.traffic["name"] == w["traffic"]
    assert (HERE / "datasets" / f"{cell.config['graph']['generator']}.py"
            ).is_file()
    for m in cell.per_layer:
        assert harness.metric_file(m["name"]).is_file()


def context(**over):
    profile = types.SimpleNamespace(
        window_s=2.0, busy_s=0.5, n_kernels=3000,
        kernels_matching=lambda pat: {"refine_rows_kernel": (10, 1e-4)}[pat])
    ctx = types.SimpleNamespace(
        window_s=50.0, completed=400, submit_s=10.0,
        counters0={"loop_iterations": 100, "wedge_exports": 1,
                   "deadend_prunes": 10, "rows_created": 1000},
        counters1={"loop_iterations": 600, "wedge_exports": 3,
                   "deadend_prunes": 30, "rows_created": 2980},
        profile=profile, profile_iterations=2, dense_refine=(10, 10 ** 8),
        device_kind="NVIDIA H100 80GB HBM3")
    for k, v in over.items():
        setattr(ctx, k, v)
    return ctx


def test_readers_on_a_synthetic_context():
    read = lambda name, ctx=None: harness.read_metric(name, ctx or context())
    assert read("submit_share_pct") == pytest.approx(20.0)
    assert read("ms_per_iteration") == pytest.approx(100.0)
    assert read("wedge_exports_per_query") == pytest.approx(2 / 400)
    assert read("kernels_per_iteration") == pytest.approx(1500.0)
    assert read("prune_rate_pct") == pytest.approx(1.0)
    assert read("device_idle_pct") == pytest.approx(75.0)
    assert read("refine_bitmap_rows_roofline") == pytest.approx(
        100 * (1e8 / 3.35e12) / 1e-4)
    assert read("kernels_per_iteration", context(profile=None)) is None
    assert read("refine_bitmap_rows_roofline",
                context(device_kind="another card")) is None
    # launches the call site did not count: no share, and the run goes on
    assert read("refine_bitmap_rows_roofline",
                context(dense_refine=(9, 1))) is None


def test_tail_reader_counts_a_query_still_running_at_the_close():
    jobs = [stats.Job(index=i, t_submit=10.0 + i, t_done=11.0 + i)
            for i in range(19)]
    jobs.append(stats.Job(index=19, t_submit=20.0))      # running at 60
    ctx = context(jobs=jobs, t0=10.0, t1=60.0)
    assert harness.read_metric("latency_p95_ms.host", ctx) == \
        pytest.approx(np.percentile([1.0] * 19 + [40.0], 95) * 1e3)


@pytest.mark.parametrize("loop", ["closed", "open", None])
def test_only_a_closed_loop_traffic_file_loads(tmp_path, loop):
    root = make_root(tmp_path)
    path = root / "portbench" / "traffic" / "t5.json"
    traffic = json.loads(path.read_text())
    traffic.pop("loop")
    if loop is not None:
        traffic["loop"] = loop
    path.write_text(json.dumps(traffic))
    if loop == "closed":
        assert harness.load_cell("tiny-t5", root).traffic["loop"] == "closed"
    else:
        with pytest.raises(ValueError, match="closed loop"):
            harness.load_cell("tiny-t5", root)
