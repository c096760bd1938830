#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``), never the JAX package:

1. prints the card (``nvidia-smi``) and builds the port's CUDA kernel
   from the sources in this checkout;
2. holds the kernel bit for bit against its plain PyTorch version on the
   card, at the main path's shape and at ragged edge cases;
3. serves three workloads through ``QueryServer(backend="engine")`` on
   the card with default knobs — 32 eight-vertex queries on the
   human-like graph (the paper's harder dataset, limit 1000), the trap
   graph (limit None) and the corridor graph submitted twice (the second
   run must warm-start from the template cache) — and checks every
   answer against the sequential oracle and the kernel's launch count
   against the megastep loop's iteration count;
4. serves the same three workloads with the plain refine on the card and
   requires identical embeddings and per-query counters. This run goes
   in a second process, at the same time as step 3: both are bound by
   the host issuing small eager ops, so they overlap on two CPU cores
   and the card (busy a few per cent) is no bottleneck;
5. times the kernel and its plain version on refine inputs captured
   from the human-like run, beside the byte bound of those inputs;
6. profiles a short window of human-like dispatches (kernel launches
   per iteration, the device's busy share).

Prints one ``[phase]`` info line per step, then the kernel table as one
JSON line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failure, a missing CUDA device or
a checkout without ``src/repro_torch`` exits non-zero without that line.
"""
from __future__ import annotations

import json
import pickle
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12           # H100 SXM non-tensor 32-bit rate (same)
N_SAMPLES = 128                 # refine calls kept from the main path
TIMING_REPS = 20


class SmokeFailure(RuntimeError):
    pass


def info(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv, default=float), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ----------------------------------------------------------------------
# phase 1: device and build
# ----------------------------------------------------------------------
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0 and out.stdout.strip(),
            f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> dict:
    from repro_torch.kernels import bitmap_refine
    _, secs, log = bitmap_refine.build(verbose=True)
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    return {"refine_bitmap_rows": {"build_s": secs, "ptxas": ptxas}}


# ----------------------------------------------------------------------
# phase 2: kernel against its plain version
# ----------------------------------------------------------------------
def refine_inputs(rng, adj_np, f: int, n_pos: int, max_depth: int):
    """Frontier rows as the megastep builds them: positions below a
    per-row depth hold data vertices, the rest -1; ``active`` marks a
    random subset of the mapped positions."""
    import numpy as np
    v = adj_np.shape[0]
    depth = rng.integers(1, max_depth + 1, f)
    frontier = rng.integers(0, v, (f, n_pos)).astype(np.int32)
    below = np.arange(n_pos)[None, :] < depth[:, None]
    frontier[~below] = -1
    active = (below & (rng.random((f, n_pos)) < 0.5)).astype(np.int32)
    cand = rng.integers(-2**31, 2**31, (f, adj_np.shape[1]),
                        dtype=np.int64).astype(np.int32)
    return cand, frontier, active


def kernel_cases(adj_human):
    """(name, adj, cand, frontier, active) numpy cases: the main-path
    shape and the ragged edges."""
    import numpy as np
    rng = np.random.default_rng(11)
    cases = []
    cases.append(("main F512 W147 NP64",
                  adj_human, *refine_inputs(rng, adj_human, 512, 64, 8)))
    for v, f in ((33, 1), (1000, 7), (4674, 333), (97, 1031)):
        w = (v + 31) // 32
        adj = rng.integers(-2**31, 2**31, (v, w), dtype=np.int64)
        adj = (adj | rng.integers(-2**31, 2**31, (v, w), dtype=np.int64)
               ).astype(np.int32)            # dense bits: ANDs stay live
        cases.append((f"ragged F{f} W{w}",
                       adj, *refine_inputs(rng, adj, f, 64, 12)))
    name, adj, cand, fr, act = cases[1 + 2]
    act = act.copy()
    act[::3] = 0
    cases.append(("rows with no active position", adj, cand, fr, act))
    fr = fr.copy()
    act = np.ones_like(act)
    fr[:, ::2] = -1
    cases.append(("active frontier == -1 lanes", adj, cand, fr, act))
    fr = fr.copy()
    fr[:, 1::4] = adj.shape[0] + 5
    cases.append(("frontier past V (clamped)", adj, cand, fr, act))
    return cases


def check_kernel(dev, cases) -> int:
    """Kernel against plain version, ``torch.equal`` (bit-exact: the
    function is integer AND, no tolerance). Returns the max abs error."""
    import torch
    from repro_torch.kernels.bitmap_refine import refine_bitmap_rows
    from repro_torch.kernels.ref import refine_bitmap_rows_ref
    worst = 0
    for name, adj, cand, fr, act in cases:
        t = [torch.from_numpy(a).to(dev) for a in (adj, cand, fr, act)]
        got = refine_bitmap_rows(*t)
        want = refine_bitmap_rows_ref(*t)
        torch.cuda.synchronize() if dev.type == "cuda" else None
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        worst = max(worst, err)
        require(torch.equal(got, want), f"kernel != plain on {name}")
        info("kernel-check", case=name, shape=list(cand.shape), equal=True)
    return worst


# ----------------------------------------------------------------------
# phases 3/4: the serving path end to end
# ----------------------------------------------------------------------
def workloads():
    from repro_torch.data.graph_gen import (corridor_graph,
                                            human_like_graph, query_set,
                                            trap_graph)
    human = human_like_graph(seed=0)
    trap_q, trap_d = trap_graph(n_b=64, n_c=64)
    corr_q, corr_d = corridor_graph()
    return {"human": (human, query_set(human, 8, 32, seed=7)),
            "trap": (trap_d, [trap_q] * 8),
            "corridor": (corr_d, [corr_q, corr_q])}


def valid_embedding(e, query, data) -> bool:
    e = [int(x) for x in e]
    if len(set(e)) != query.n:
        return False
    if any(data.labels[e[u]] != query.labels[u] for u in range(query.n)):
        return False
    return all(data.has_edge(e[u], e[int(w)])
               for u in range(query.n) for w in query.neighbors(u))


def emb_set(embs) -> set:
    return {tuple(int(x) for x in e) for e in embs}


def serve(dev, wl, capture=None) -> dict:
    """Run the workloads through the port's QueryServer on ``dev``.
    ``capture`` records refine inputs of the human-like run (it copies
    them and launches no kernel). Returns per-workload results and
    scheduler figures."""
    import torch
    from repro_torch.core import engine_step
    from repro_torch.serving import QueryServer

    out = {}
    for name, (data, queries) in wl.items():
        knobs = {} if name == "human" else {"limit": None}
        srv = QueryServer(data, backend="engine", device=dev, **knobs)
        real = engine_step.refine_bitmap_rows
        if capture is not None and name == "human":
            engine_step.refine_bitmap_rows = capture(real)
        try:
            t0 = time.perf_counter()
            if name == "corridor":
                res = [srv.submit(i, q) for i, q in enumerate(queries)]
            else:
                res = srv.submit_batch(queries)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            engine_step.refine_bitmap_rows = real
        sched = srv.scheduler
        out[name] = {"results": res, "wall_s": wall,
                     "slo": srv.slo_report(),
                     "iterations": sched.timing["iterations"],
                     "readback_s": sched.timing["readback_s"],
                     "readbacks": sched.timing["readbacks"],
                     "dispatches": sched.n_dispatches,
                     "dispatch_s": sched.t_dispatch_s,
                     "exports": sched.n_exported}
    return out


def check_answers(run, wl) -> None:
    from repro_torch.core.backtrack import backtrack_deadend
    data, queries = wl["human"]
    for i, (q, r) in enumerate(zip(queries, run["human"]["results"])):
        require(r.status in ("ok", "limit"), f"human q{i}: {r.status}")
        require(all(valid_embedding(e, q, data) for e in r.embeddings),
                f"human q{i}: invalid embedding row")
        require(len(emb_set(r.embeddings)) == len(r.embeddings),
                f"human q{i}: duplicate embedding")
        want = len(backtrack_deadend(q, data, limit=1000).embeddings)
        require(len(r.embeddings) == want,
                f"human q{i}: {len(r.embeddings)} embeddings, oracle {want}")
    for name in ("trap", "corridor"):
        data, queries = wl[name]
        oracle = emb_set(backtrack_deadend(queries[0], data,
                                           limit=None).embeddings)
        for i, r in enumerate(run[name]["results"]):
            require(r.status == "ok", f"{name} q{i}: {r.status}")
            require(emb_set(r.embeddings) == oracle,
                    f"{name} q{i}: embedding set differs from the oracle")
    require(sum(r.stats.deadend_prunes
                for r in run["trap"]["results"]) > 0, "trap: no prunes")
    require(bool(run["corridor"]["results"][1].stats.cache_hit),
            "corridor: the second run did not hit the template cache")


def run_digest(run) -> dict:
    """What the kernel and plain runs must agree on, per workload and
    query: embedding set and the prune / row / store counters."""
    return {name: [(sorted(emb_set(r.embeddings)),
                    {k: int(getattr(r.stats, k)) for k in
                     ("deadend_prunes", "rows_created", "patterns_stored")})
                   for r in w["results"]]
            for name, w in run.items()}


def same_runs(a: dict, b: dict) -> None:
    for name in a:
        require(len(a[name]) == len(b[name]), f"{name}: query counts differ")
        for i, ((ea, ca), (eb, cb)) in enumerate(zip(a[name], b[name])):
            require(ea == eb, f"{name} q{i}: kernel and plain runs differ")
            for k in ca:
                require(ca[k] == cb[k], f"{name} q{i}: {k} differs between "
                        "kernel and plain runs")


def run_summary(run) -> dict:
    h = run["human"]
    slo = h["slo"]
    return {"qps": len(h["results"]) / h["wall_s"], "wall_s": h["wall_s"],
            "p50_ms": slo["p50_ms"], "p99_ms": slo["p99_ms"],
            "dispatches": h["dispatches"],
            "mean_dispatch_ms": 1e3 * h["dispatch_s"] / max(1,
                                                            h["dispatches"]),
            "loop_iterations": h["iterations"],
            "wedge_exports": h["exports"],
            "readbacks": h["readbacks"],
            "readback_share": h["readback_s"] / h["wall_s"],
            "found": sum(len(r.embeddings) for r in h["results"]),
            "prunes": sum(r.stats.deadend_prunes for r in h["results"]),
            "trap_wall_s": run["trap"]["wall_s"],
            "trap_prunes": sum(r.stats.deadend_prunes
                               for r in run["trap"]["results"]),
            "corridor_wall_s": run["corridor"]["wall_s"]}


# ----------------------------------------------------------------------
# phase 5: timing on captured main-path inputs
# ----------------------------------------------------------------------
def sampler(samples: list):
    """Wrap a refine function so it keeps a uniform sample (reservoir,
    seeded) of the inputs it is called with."""
    rng = random.Random(0)
    seen = [0]

    def wrap(real):
        def recorded(adj, cand, frontier, active):
            k = seen[0]
            seen[0] += 1
            j = k if k < N_SAMPLES else rng.randrange(k + 1)
            if j < N_SAMPLES:           # copy only the inputs kept
                item = (adj, cand.clone(), frontier.clone(), active.clone())
                if j == len(samples):
                    samples.append(item)
                else:
                    samples[j] = item
            return real(adj, cand, frontier, active)
        return recorded
    return wrap


def bound_of(adj, cand, frontier, active) -> tuple[float, float]:
    """Least time (ms) for one call on these inputs, as (bytes, ops):
    each input byte read once (of the adjacency, only the rows these
    inputs reference), each output byte written once, over the HBM rate;
    one AND per gathered word over the 32-bit rate."""
    import torch
    f, w = cand.shape
    use = (active != 0) & (frontier >= 0)
    rows = torch.unique(frontier[use].clamp(max=adj.shape[0] - 1)).numel()
    nbytes = 4 * (2 * f * w + frontier.numel() + active.numel() + rows * w)
    ops = int(use.sum()) * w
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT_OPS_PER_S


def device_ms(fn, samples) -> float:
    """Device time of one call, averaged over ``samples``: the calls are
    captured into one CUDA graph and the replays timed with CUDA events,
    so host launch cost is not in the figure."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for s in samples:
            fn(*s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for s in samples:
            fn(*s)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMING_REPS):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (TIMING_REPS * len(samples))


def eager_ms(fn, samples) -> float:
    """Per-call time as the eager main path sees it (launch included)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMING_REPS):
        for s in samples:
            fn(*s)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (TIMING_REPS * len(samples))


def time_kernel(samples) -> dict:
    import torch
    from repro_torch.kernels.bitmap_refine import refine_bitmap_rows
    from repro_torch.kernels.ref import refine_bitmap_rows_ref
    worst = 0
    for s in samples:
        got, want = refine_bitmap_rows(*s), refine_bitmap_rows_ref(*s)
        worst = max(worst, int((got.long() - want.long()).abs().max()))
        require(torch.equal(got, want),
                "kernel != plain on a captured main-path input")
    bounds = [bound_of(*s) for s in samples]
    t_bytes = sum(b for b, _ in bounds) / len(bounds)
    t_ops = sum(o for _, o in bounds) / len(bounds)
    ms = device_ms(refine_bitmap_rows, samples)
    plain_ms = device_ms(refine_bitmap_rows_ref, samples)
    gathered = [int(((s[3] != 0) & (s[2] >= 0)).sum()) for s in samples]
    return {"ms": ms, "eager_ms": eager_ms(refine_bitmap_rows, samples),
            "plain_ms": plain_ms,
            "plain_eager_ms": eager_ms(refine_bitmap_rows_ref, samples),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
            "max_abs_err": worst, "samples": len(samples),
            "gathered_rows_per_call": sum(gathered) / len(gathered),
            "shape": list(samples[0][1].shape)}


def profile_window(dev, wl, steps: int = 10) -> dict:
    """Where a human-like dispatch's time goes: ``torch.profiler`` (CPU
    and CUDA) over ``steps`` scheduler steps of 8 queries — kernel
    launches and device time (kernels, copies and fills on the card) per
    expansion iteration. The profiler slows the host, so the window's own
    busy share understates the unprofiled one; ``main`` also sets the
    device time per iteration against the main run's wall time per
    iteration. A measurement, not a check: if the profiler cannot trace
    the card here, the figures read "not measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import QueryServer

    data, queries = wl["human"]
    srv = QueryServer(data, backend="engine", device=dev)
    for q in queries[:8]:
        srv.submit_async(q)
    for _ in range(3):                  # admission and the first dispatches
        srv.step()
    sched = srv.scheduler
    it0 = sched.timing["iterations"]
    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                srv.step()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = prof.key_averages()
    except Exception as exc:            # tracing unavailable on this host
        return {"profiled": False, "error": repr(exc)}
    iters = max(1, sched.timing["iterations"] - it0)

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)
    on_card = [e for e in stats
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in on_card)
    launches = sum(e.count for e in stats
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    top_cpu = sorted(stats, key=lambda e: -e.self_cpu_time_total)[:8]
    top_dev = sorted(on_card, key=lambda e: -dev_us(e))[:5]
    if busy_us <= 0:
        return {"profiled": False, "iterations": iters,
                "kernel_launches_per_iteration": launches / iters}
    return {"profiled": True, "iterations": iters, "wall_s": wall,
            "kernel_launches_per_iteration": launches / iters,
            "device_ms_per_iteration": busy_us / 1e3 / iters,
            "profiled_wall_ms_per_iteration": wall * 1e3 / iters,
            "profiled_busy_share": busy_us / (wall * 1e6),
            "top_self_cpu_us": [[e.key, e.count, e.self_cpu_time_total]
                                for e in top_cpu],
            "top_device_us": [[e.key[:60], e.count, dev_us(e)]
                              for e in top_dev]}


# ----------------------------------------------------------------------
def warm_up(dev, wl) -> None:
    """CUDA context and first launches, outside every counted run."""
    serve(dev, {"corridor": wl["corridor"]})


def plain_run(out_path: str) -> int:
    """Phase 4, in its own process: the three workloads with the plain
    refine forced on the card. Writes the run's digest and summary."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import bitmap_refine
    from repro_torch.kernels.config import backend_scope
    dev = torch.device("cuda")
    wl = workloads()
    with backend_scope("torch"):
        warm_up(dev, wl)
        run = serve(dev, wl)
    require(bitmap_refine.LAUNCHES == 0,
            "the kernel launched under backend_scope('torch')")
    with open(out_path, "wb") as f:
        pickle.dump({"digest": run_digest(run),
                     "summary": run_summary(run)}, f)
    return 0


def start_plain_run(out_path: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--plain-run", out_path],
                            stdout=subprocess.DEVNULL)


def finish_plain_run(proc: subprocess.Popen, out_path: str) -> dict:
    rc = proc.wait()
    require(rc == 0, f"the plain-refine run failed (exit code {rc})")
    with open(out_path, "rb") as f:
        return pickle.load(f)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not here ({exc})", file=sys.stderr)
        return 2
    from repro_torch.kernels import bitmap_refine

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    info("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    info("build", **build_kernels())

    wl = workloads()
    human = wl["human"][0]
    cases = kernel_cases(human.adj_bitmap.view("int32"))
    worst = check_kernel(dev, cases)
    warm_up(dev, wl)

    with tempfile.TemporaryDirectory() as tmp:
        plain_path = str(Path(tmp) / "plain_run.pkl")
        proc = start_plain_run(plain_path)
        try:
            samples: list = []
            bitmap_refine.LAUNCHES = 0
            run_k = serve(dev, wl, capture=sampler(samples))
            launches = bitmap_refine.LAUNCHES
            iters = sum(r["iterations"] for r in run_k.values())
            require(launches > 0, "the refine kernel was never launched")
            require(launches == iters,
                    f"refine launches {launches} != megastep iterations "
                    f"{iters}")
            check_answers(run_k, wl)
            info("serve-kernel", launches=launches, iterations=iters,
                 **run_summary(run_k))
            plain = finish_plain_run(proc, plain_path)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    same_runs(run_digest(run_k), plain["digest"])
    info("serve-plain", identical=True, **plain["summary"])

    timing = time_kernel(samples)
    info("kernel-time", **timing)
    prof = profile_window(dev, wl)
    if prof["profiled"]:
        h = run_k["human"]
        wall_ms = 1e3 * h["wall_s"] / max(1, h["iterations"])
        prof["main_run_wall_ms_per_iteration"] = wall_ms
        prof["device_busy_share_est"] = prof["device_ms_per_iteration"] \
            / wall_ms
    info("profile", **prof)
    row = {"name": "refine_bitmap_rows", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/bitmap_refine.cu",
           "replaces": "src/repro/kernels/bitmap_refine.py:100",
           "launches": launches,
           "max_abs_err": max(worst, timing["max_abs_err"]),
           "ms": timing["ms"], "plain_ms": timing["plain_ms"],
           "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
           "library_ms": None}
    info("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--plain-run"]:
            sys.exit(plain_run(sys.argv[2]))
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
