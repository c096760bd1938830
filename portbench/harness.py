"""One run of one cell of the port's benchmark.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``portbench/configs/<config>.json``: the data graph's generator and
seed, the engine knobs, the per-query limit) and a traffic mix
(``portbench/traffic/<traffic>.json``: the loop, which must be
``"closed"``, clients, query size, pool size, warm-up and drain).
Per-layer metrics are files ``portbench/metrics/<name>.py``, each with
``read(ctx)``.

The run: load (or build once) the data graph, draw the query pool from
``--seed``, start ``repro_torch.serving.QueryServer(backend="engine")``
with the configuration's knobs, warm up the closed loop until every
client has been answered, then drive it for ``--seconds``: each client
submits its next query as soon as its last one is answered. After the
window the answers still due are waited for, the peak device memory is
read, the server is freed, and every answer of the window is judged
against the plain reference (``reference/match.py``) on the host.

The last line of standard output is the result, as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import stats
from .datasets import cache
from .guard import forbidden_modules
from .reference.match import DataGraph, Query, enumerate_embeddings, row_faults
from .queries import query_pool

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# a traced run asks the profiler to start this long, plus the traffic's
# profile_s, before the window closes: it takes about 5 s to start (one
# H100), and the profiled part counts from when it has
PROFILE_LEAD_S = 12.0


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell's configuration, traffic and metric entries, found by
    the names ``BENCHMARK.json`` gives."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    if traffic.get("loop") != "closed":
        raise ValueError(f"traffic {w['traffic']!r} asks for loop "
                         f"{traffic.get('loop')!r}: only a closed loop is "
                         "driven")
    per_layer = [m for m in bench["per_layer"] if applies(m, workload)]
    for m in per_layer:
        metric_file(m["name"], root)
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, workload)],
                per_layer=per_layer)


def metric_file(name: str, root: Path = ROOT) -> Path:
    path = root / "portbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path} for metric {name!r}")
    return path


def read_metric(name: str, ctx, root: Path = ROOT):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", metric_file(name, root))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


@dataclasses.dataclass
class Context:
    """What a per-layer metric reader may read. ``[t0, t1]`` is the
    window up to the profiler's start (``Profiling.head``)."""
    cell: Cell
    window_s: float             # t1 - t0
    jobs: list                  # stats.Job of the whole run
    t0: float
    t1: float
    completed: int              # queries answered in (t0, t1]
    counters0: dict             # scheduler_stats() at t0
    counters1: dict             # ... and at t1
    submit_s: float             # seconds inside submit_async
    profile: object = None      # trace.Summary of the profiled part
    profile_iterations: int = 0  # megastep loop iterations in it
    dense_refine: tuple = (0, 0)  # (calls, least bytes) in it
    device_kind: str = ""
    power_limit_w: float | None = None


# ---------------------------------------------------------------------
# the program's side
# ---------------------------------------------------------------------
def port_graph(arrays: dict):
    from repro_torch.core.graph import Graph
    return Graph(n=int(arrays["n"]), labels=arrays["labels"],
                 indptr=arrays["indptr"], indices=arrays["indices"],
                 n_labels=int(arrays["n_labels"]))


def port_query(q: Query, n_labels: int):
    from repro_torch.core.graph import Graph
    return Graph.from_edges(q.k, [tuple(e) for e in q.edges.tolist()],
                            q.labels, n_labels)


class Loop:
    """The closed loop: one outstanding query per client."""

    def __init__(self, server, pool: list, clients: int):
        self.server = server
        self.pool = pool
        self.next = 0
        self.clients: list[stats.Job | None] = [None] * clients
        self.jobs: list[stats.Job] = []
        self.submit_s = 0.0
        self.answered = [0] * clients
        self.profiling = None       # set for the traced part of a run

    def _span(self, name: str):
        if self.profiling is not None and self.profiling.on:
            import torch
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def submit(self, c: int) -> None:
        if self.next >= len(self.pool):
            raise RuntimeError(
                f"query pool of {len(self.pool)} exhausted: raise the "
                "traffic file's pool")
        job = stats.Job(index=self.next, t_submit=time.perf_counter())
        with self._span("submit_async"):
            job.handle = self.server.submit_async(self.pool[self.next])
        self.submit_s += time.perf_counter() - job.t_submit
        self.next += 1
        self.clients[c] = job
        self.jobs.append(job)
        self.poll_one(c, time.perf_counter())

    def poll_one(self, c: int, now: float) -> None:
        job = self.clients[c]
        h = job.handle
        # first embedding: the first poll at which the handle holds a
        # delivered batch (the buffer its stream() drains), or its end
        if job.t_first is None and (h._batches or h.done()):
            job.t_first = now
        if h.done():
            job.t_done = now
            self.answered[c] += 1
            self.clients[c] = None

    def start(self) -> None:
        for c in range(len(self.clients)):
            self.submit(c)

    def run(self, until: float, refill: bool = True,
            hook=None) -> None:
        """Step and poll until ``until`` (host clock); each answered
        client submits again when ``refill``. ``hook(now)`` runs after
        every poll."""
        while True:
            now = time.perf_counter()
            if now >= until:
                return
            with self._span("step"):
                self.server.step()
            now = time.perf_counter()
            for c, job in enumerate(self.clients):
                if job is not None:
                    self.poll_one(c, now)
                    if self.clients[c] is None and refill:
                        self.submit(c)
            if hook is not None:
                hook(now)
            if not refill and all(j is None for j in self.clients):
                return


class Profiling:
    """Profiles ``[start, start + seconds)`` of the window (traced runs
    only). ``head`` keeps the host clock, ``scheduler_stats()`` and the
    seconds inside ``submit_async`` as the profiler is started: the
    per-layer counters are read over the window up to then, since the
    profiler slows the loop while it runs and stalls it for seconds as it
    stops."""

    def __init__(self, start: float, seconds: float, engine_step,
                 scheduler, loop):
        import torch
        from .refine_count import RefineCounter
        self.torch = torch
        self.start_at, self.seconds = start, seconds
        self.stop_at = float("inf")
        self.on = False
        self.done = False
        self.prof = None
        self.range = None
        self.counter = RefineCounter(engine_step)
        self.iter0 = self.iter1 = 0
        self.scheduler = scheduler
        self.loop = loop
        self.head = None
        self.started_s = None      # how long the profiler took to start

    def __call__(self, now: float) -> None:
        torch = self.torch
        if not self.on and not self.done and now >= self.start_at:
            self.head = (time.perf_counter(),
                         self.scheduler.scheduler_stats(),
                         self.loop.submit_s)
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.range = torch.profiler.record_function("portbench.profiled")
            self.range.__enter__()
            self.iter0 = self.scheduler.timing.get("iterations", 0)
            self.counter.__enter__()
            self.counter.armed = True
            self.on = True
            self.started_s = time.perf_counter() - self.head[0]
            self.stop_at = time.perf_counter() + self.seconds
        elif self.on and now >= self.stop_at:
            self.counter.armed = False
            self.counter.__exit__(None, None, None)
            torch.cuda.synchronize()
            self.iter1 = self.scheduler.timing.get("iterations", 0)
            self.range.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.on = False
            self.done = True

    def summary(self):
        from .trace import reduce_events
        events = self.prof.profiler.kineto_results.events()
        return reduce_events(events, {self.torch.autograd.DeviceType.CUDA})

    def export(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(path))


# ---------------------------------------------------------------------
# the judge
# ---------------------------------------------------------------------
CHECKS = (("missing", "max", 0), ("bad_status", "max", 0),
          ("invalid_rows", "max", 0), ("duplicate_rows", "max", 0),
          ("count_mismatch", "max", 0), ("judged", "min", 1))


def judge(answers: list, queries: list[Query], g: DataGraph, limit: int,
          missing: int) -> tuple[dict, int]:
    """``(checks, failed)``: each number compared with its limit, and
    the queries that failed. ``answers`` holds ``(pool index, status,
    n_found, embeddings)`` of every answer judged; ``missing`` counts
    the answers that never came."""
    n = dict(missing=missing, bad_status=0, invalid_rows=0,
             duplicate_rows=0, count_mismatch=0, judged=len(answers))
    failed = missing
    for idx, status, n_found, emb in answers:
        q = queries[idx]
        rows = (np.stack([np.asarray(e, np.int64) for e in emb])
                if len(emb) else np.zeros((0, q.k), np.int64))
        invalid, dup = row_faults(q, g, rows)
        want, _ = enumerate_embeddings(q, g, limit)
        wrong_status = (status not in ("ok", "limit")
                        or (status == "limit") != (n_found >= limit))
        mismatch = n_found != want or rows.shape[0] != n_found
        n["invalid_rows"] += invalid
        n["duplicate_rows"] += dup
        n["bad_status"] += int(wrong_status)
        n["count_mismatch"] += int(mismatch)
        failed += int(bool(invalid or dup or wrong_status or mismatch))
    checks = {}
    for name, kind, lim in CHECKS:
        checks[name] = {"value": n[name], kind: lim}
    return checks, failed


def passes(checks: dict) -> bool:
    return all((c["value"] <= c["max"]) if "max" in c else
               (c["value"] >= c["min"]) for c in checks.values())


def check_lines(checks: dict) -> list[str]:
    return [f"check {name}: {c['value']} "
            + (f"<= {c['max']}" if "max" in c else f">= {c['min']}")
            for name, c in checks.items()]


# ---------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------
def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def run(args: argparse.Namespace, t_start: float, device: str = "cuda",
        root: Path = ROOT, fault=None) -> tuple[int, dict | None]:
    """``(exit code, result)``. ``device`` other than ``"cuda"`` and
    ``fault`` (a callable given the server before the warm-up, which may
    break it) exist for the CPU tests of the judge; the command line
    always runs on the card."""
    import torch
    cell = load_cell(args.workload, root)
    if device == "cuda":
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            log(f"needs {cell.chips} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2, None
    phases = {"start": time.perf_counter() - t_start}
    cfg, traffic = cell.config, cell.traffic
    limit = int(cfg["limit"])
    arrays, built = cache.load(cfg["name"], cfg["graph"],
                               root / "portbench" / ".cache")
    g = DataGraph.of(arrays)
    data = port_graph(arrays)
    k = int(traffic["query_vertices"])
    queries = query_pool(g, k, int(traffic["pool"]), args.seed)
    pool = [port_query(q, data.n_labels) for q in queries]
    phases["inputs"] = time.perf_counter() - t_start

    from repro_torch.core import engine_step
    from repro_torch.serving.query_server import QueryServer
    server = QueryServer(data, backend="engine", device=device,
                         limit=limit, **cfg["engine"])
    if fault is not None:
        fault(server)
    phases["server"] = time.perf_counter() - t_start
    clients = int(traffic["clients"])
    trace = bool(args.trace) and device == "cuda"
    profiling = None
    loop = Loop(server, pool, clients)

    # warm-up: the cell's own closed loop until every client has been
    # answered (or the traffic's cap passes)
    t_w = time.perf_counter()
    cap = t_w + float(traffic["warmup_max_s"])
    loop.start()
    while min(loop.answered) < 1 and time.perf_counter() < cap:
        loop.run(min(cap, time.perf_counter() + 1.0))
    warmup_s = time.perf_counter() - t_w
    if device == "cuda":
        torch.cuda.synchronize()
    sched = server.scheduler
    counters0 = sched.scheduler_stats()
    gc.collect()
    gc.freeze()

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    seconds = float(args.seconds)
    if trace:
        # the profiled part ends the window, and the profiler takes a
        # while to start
        span = min(float(traffic["profile_s"]), seconds)
        profiling = Profiling(t0 + max(0.0, seconds - span - PROFILE_LEAD_S),
                              span, engine_step, sched, loop)
        loop.profiling = profiling
    loop.submit_s = 0.0
    loop.run(t0 + seconds, hook=profiling)
    t1 = time.perf_counter()
    if profiling is not None and profiling.on:
        profiling(float("inf"))
    counters1 = sched.scheduler_stats()

    # answers still due: wait for them, up to the traffic's drain limit
    loop.run(t1 + float(traffic["drain_max_s"]), refill=False)
    missing = sum(j is not None for j in loop.clients)
    if device == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated(0))
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, str(device)
    window = stats.window_jobs(loop.jobs, t0, t1)
    answers = []
    for j in window:
        if j.handle.done():
            r = j.handle.result()
            answers.append((j.index, r.status, int(r.n_found),
                            r.embeddings))
        j.handle = None        # the handles hold the session
    # per-layer counters: over the window, or in a traced run over its
    # part before the profiler started
    t_h, counters_h, submit_h = (
        profiling.head if profiling is not None and profiling.head
        else (t1, counters1, loop.submit_s))
    done_by = lambda t: sum(1 for j in loop.jobs
                            if j.t_done is not None and t0 < j.t_done <= t)
    completed = done_by(t1)
    ctx = Context(cell=cell, window_s=t_h - t0, jobs=loop.jobs, t0=t0,
                  t1=t_h, completed=done_by(t_h), counters0=counters0,
                  counters1=counters_h, submit_s=submit_h,
                  device_kind=kind)
    summary = None
    prof_start = "-"
    if trace and profiling is not None and profiling.done:
        prof_start = f"{profiling.started_s:.3f} s"
        summary = profiling.summary()
        ctx.profile = summary
        ctx.profile_iterations = profiling.iter1 - profiling.iter0
        ctx.dense_refine = profiling.counter.total_bytes()
        ctx.power_limit_w = power_limit_w()
        tdir = root / "portbench" / ".runs"
        profiling.export(tdir / f"trace-{cell.name}-{args.seed}.json.gz")
        profiling = None
    layout = counters1.get("adjacency_variant")
    del server, sched
    loop.server = None
    for j in loop.jobs:
        j.handle = None
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t_j = time.perf_counter()
    checks, failed = judge(answers, queries, g, limit, missing)
    judge_s = time.perf_counter() - t_j
    correct = passes(checks)

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx, root)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"qps": lambda: stats.qps(loop.jobs, t0, t1),
               "latency_p95_ms": lambda: stats.p95_ms(
                   stats.latencies_s(loop.jobs, t0, t1)),
               "ttfe_p95_ms": lambda: stats.p95_ms(
                   stats.ttfes_s(loop.jobs, t0, t1)),
               "setup_s": lambda: setup_s}
        for m in cell.end_to_end:
            v = e2e[m["name"]]()
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else str(device),
           "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        dev["power_limit_w"] = ctx.power_limit_w
    result = {"correct": bool(correct), "attempted": len(window),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {
            "device_ops": summary.device_ops(10),
            "idle_gaps": [[k, v] for k, v in summary.idle_gaps]}
    faults = {k: v for k, v in counters1.get("faults", {}).items() if v}
    longest = max((j.t_done - j.t_submit for j in loop.jobs
                   if j.t_done is not None), default=0.0)
    log(f"cell {cell.name} seed {args.seed}: dataset "
        f"{'built' if built else 'cached'}, layout {layout}, warm-up "
        f"{warmup_s:.3f} s, window {t1 - t0:.3f} s, profiler start "
        f"{prof_start}, completed {completed}, "
        f"in flight at close {len(window) - completed}, longest answer "
        f"{longest:.3f} s, pool used "
        f"{loop.next} of {len(pool)}, setup {setup_s:.3f} s, judge "
        f"{judge_s:.3f} s, peak {peak} B, faults {faults or 'none'}, "
        f"set-up phases (s from start) "
        f"{ {k: round(v, 3) for k, v in phases.items()} }")
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3, None
    result["checks"] = checks
    for line in check_lines(checks):
        log(line)
    return 0, result


def main(argv: list[str], t_start: float) -> int:
    args = parse(argv)
    code, result = run(args, t_start)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code
