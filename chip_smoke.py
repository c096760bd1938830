#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``), never the JAX package:

1. prints the card (``nvidia-smi``) and builds the port's two CUDA
   kernels from the sources in this checkout, one ``nvcc`` each, at the
   same time;
2. holds each kernel bit for bit against its plain PyTorch version on
   the card: the dense refine at the human-like main-path shape and at
   ragged edge cases; the hierarchical refine at the scale graph's
   main-path shape, at chunk widths 1, 4, 8 and 16 (one wider than the
   row), at ragged edge cases and on a 262144-vertex graph;
3. serves five workloads through ``QueryServer(backend="engine")`` on
   the card with default knobs — 16 eight-vertex queries on the
   human-like graph (limit 1000), the trap graph (limit None), the
   corridor graph submitted twice (the second run must warm-start from
   the template cache), the trap graph with a 16-entry device stack (its
   queries must wedge and be exported to host segments), and the
   ``scale`` workload: 32 eight-vertex queries on a 65536-vertex
   power-law graph (limit 1000), which takes the hierarchical adjacency
   layout and its kernel. Every answer is checked against the sequential
   oracle, and each kernel's launch count, set to 0 before each workload
   and read after it, against that workload's megastep iterations;
4. serves the same workloads with the plain refines on the card and
   requires identical embeddings and per-query counters. This run goes
   in a second process, started right after the build: both runs are
   bound by the host issuing small eager ops, so they overlap on two CPU
   cores and the card (busy a few per cent) is no bottleneck;
5. holds the hierarchical kernel against the dense kernel on the dense
   bitmap of the same 65536-vertex graph, on refine inputs captured from
   the scale run;
6. times each kernel and its plain version on inputs captured from its
   run (human-like for the dense, scale for the hierarchical), beside
   the bound of those inputs;
7. profiles a short window of human-like and of scale dispatches
   (kernel launches per iteration, the device's busy share).

Prints one ``[phase]`` info line per step (the ``done`` line gives the
script's own seconds), then the kernel table as one JSON line, the
card's name and power limit, and as its last line
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
N_SAMPLES = 128                 # refine calls kept from each captured run
N_TIMED_HIER = 32               # of those, timed for the hier kernel
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
    t0 = time.perf_counter()
    built = bitmap_refine.build_all(verbose=True)
    out = {"wall_s": time.perf_counter() - t0}
    for name, (_, secs, log) in built.items():
        out[name] = {"build_s": secs,
                     "ptxas": [ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln
                               or "smem" in ln]}
    return out


# ----------------------------------------------------------------------
# phase 2: kernel against its plain version
# ----------------------------------------------------------------------
def refine_inputs(rng, v: int, w: int, f: int, n_pos: int,
                  max_depth: int):
    """Frontier rows as the megastep builds them: positions below a
    per-row depth hold data vertices, the rest -1; ``active`` marks a
    random subset of the mapped positions."""
    import numpy as np
    depth = rng.integers(1, max_depth + 1, f)
    frontier = rng.integers(0, v, (f, n_pos)).astype(np.int32)
    below = np.arange(n_pos)[None, :] < depth[:, None]
    frontier[~below] = -1
    active = (below & (rng.random((f, n_pos)) < 0.5)).astype(np.int32)
    cand = rng.integers(-2**31, 2**31, (f, w),
                        dtype=np.int64).astype(np.int32)
    return cand, frontier, active


def kernel_cases(adj_human):
    """(name, adj, cand, frontier, active) numpy cases: the main-path
    shape and the ragged edges."""
    import numpy as np
    rng = np.random.default_rng(11)
    cases = []
    cases.append(("main F512 W147 NP64", adj_human,
                  *refine_inputs(rng, *adj_human.shape, 512, 64, 8)))
    for v, f in ((33, 1), (1000, 7), (4674, 333), (97, 1031)):
        w = (v + 31) // 32
        adj = rng.integers(-2**31, 2**31, (v, w), dtype=np.int64)
        adj = (adj | rng.integers(-2**31, 2**31, (v, w), dtype=np.int64)
               ).astype(np.int32)            # dense bits: ANDs stay live
        cases.append((f"ragged F{f} W{w}",
                       adj, *refine_inputs(rng, *adj.shape, f, 64, 12)))
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


def hier_lanes(hb) -> list:
    """The two-level layout's device lanes as int32 numpy arrays."""
    return [hb.summary.view("int32"), hb.chunk_ptr, hb.chunk_id,
            hb.chunk_data.view("int32")]


def random_hier(rng, v: int, cw: int):
    """Two-level layout of a random symmetric graph with ``v`` vertices."""
    import numpy as np
    from repro_torch.core.graph import build_hier_bitmap
    dense = rng.random((v, v)) < 0.2
    dense |= dense.T
    indptr = np.concatenate(([0], np.cumsum(dense.sum(axis=1))))
    return build_hier_bitmap(v, indptr, np.nonzero(dense)[1],
                             chunk_words=cw)


def hier_case(rng, name, hb, f, n_pos=64, max_depth=8, hubs=0):
    """(name, lanes, kmax, cand, frontier, active): refine inputs as the
    megastep builds them; ``hubs`` > 0 puts a vertex below ``hubs`` (the
    degree-sorted hubs) at position 0 of every other row, so rows stay
    live through many chunks."""
    v = hb.summary.shape[0]
    cand, frontier, active = refine_inputs(rng, v, (v + 31) // 32, f,
                                           n_pos, max_depth)
    if hubs:
        frontier[::2, 0] = rng.integers(0, hubs, frontier[::2].shape[0])
        active[::2, 0] = 1
    return (name, hier_lanes(hb), hb.kmax, cand, frontier, active)


def hier_cases(scale_graph, big_n: int = 262144):
    """The hierarchical kernel's cases: the scale graph's main-path shape,
    chunk widths 1 / 4 / 8 / 16 (16 wider than a 2-word row), ragged F,
    rows with no active position, ``frontier == -1`` and past-V lanes,
    all-dead summary rows, and a ``big_n``-vertex power-law graph."""
    import numpy as np
    from repro_torch.data.graph_gen import powerlaw_graph
    rng = np.random.default_rng(12)
    hb = scale_graph.hier_bitmap(8)
    cases = [hier_case(rng, f"scale F512 W{(scale_graph.n + 31) // 32} "
                       f"SW{hb.summary.shape[1]} C8", hb, 512, hubs=64)]
    for v, cw, f in ((300, 1, 37), (300, 4, 37), (300, 8, 37),
                     (64, 16, 5), (1000, 4, 1), (1000, 8, 1031)):
        cases.append(hier_case(rng, f"C{cw} V{v} F{f}", random_hier(
            rng, v, cw), f, max_depth=12))
    name, lanes, kmax, cand, fr, act = hier_case(
        rng, "", random_hier(rng, 520, 4), 333, max_depth=12)
    act = act.copy()
    act[::3] = 0
    cases.append(("rows with no active position", lanes, kmax, cand, fr,
                  act))
    fr, act = fr.copy(), np.ones_like(act)
    fr[:, ::2] = -1
    cases.append(("active frontier == -1 lanes", lanes, kmax, cand, fr, act))
    fr, act = fr.copy(), act.copy()
    fr[1::2, 1::4] = 520 + 5
    act[1::4, 2:] = 0           # rows whose only active position is past V
    cases.append(("frontier past V", lanes, kmax, cand, fr, act))
    # all-dead summaries: cand lives only in a chunk the row's one active
    # vertex has no neighbour in (or cand is all zero)
    summary = lanes[0].view("uint32")
    cand, fr, act = cand.copy(), fr.copy(), np.zeros_like(act)
    fr[:, 0] = rng.integers(0, 520, fr.shape[0])
    act[:, 0] = 1
    n_chunks = (cand.shape[1] + 3) // 4
    for i in range(0, cand.shape[0], 2):
        dead = [c for c in range(n_chunks)
                if not (summary[fr[i, 0], 0] >> np.uint32(c)) & 1]
        cand[i] = 0
        if dead and i % 4 == 0:
            cand[i, 4 * dead[0]:4 * dead[0] + 4] = -1
    cases.append(("all-dead summary rows", lanes, kmax, cand, fr, act))
    big = powerlaw_graph(big_n, 3, 16, seed=0).hier_bitmap(8)
    cases.append(hier_case(
        rng, f"V{big_n} F512 W{(big_n + 31) // 32} "
        f"SW{big.summary.shape[1]} C8", big, 512, hubs=64))
    return cases


def check_hier_kernel(dev, cases) -> int:
    """Hierarchical kernel against its plain version, ``torch.equal``
    (bit-exact: integer AND and OR, no tolerance). Returns the max abs
    error."""
    import torch
    from repro_torch.kernels.bitmap_refine import refine_bitmap_rows_hier
    from repro_torch.kernels.ref import refine_bitmap_rows_hier_ref
    worst = 0
    for name, lanes, kmax, cand, fr, act in cases:
        lt = [torch.from_numpy(a).to(dev) for a in lanes]
        rt = [torch.from_numpy(a).to(dev) for a in (cand, fr, act)]
        got = refine_bitmap_rows_hier(*lt, kmax, *rt)
        want = refine_bitmap_rows_hier_ref(*lt, kmax, *rt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        worst = max(worst, err)
        require(torch.equal(got, want), f"hier kernel != plain on {name}")
        info("hier-kernel-check", case=name, shape=list(cand.shape),
             chunk_words=int(lanes[3].shape[1]), kmax=kmax,
             zero_rows=int((got == 0).all(dim=1).sum()), equal=True)
    return worst


# ----------------------------------------------------------------------
# phases 3/4: the serving path end to end
# ----------------------------------------------------------------------
# name -> knobs; human and scale keep the default limit (1000)
KNOBS = {"human": {}, "trap": {"limit": None}, "corridor": {"limit": None},
         "wedge": {"limit": None, "stack_capacity": 16}, "scale": {}}
LIMITED = ("human", "scale")


def workloads():
    from repro_torch.data.graph_gen import (corridor_graph,
                                            human_like_graph, powerlaw_graph,
                                            query_set, trap_graph)
    human = human_like_graph(seed=0)
    trap_q, trap_d = trap_graph(n_b=64, n_c=64)
    corr_q, corr_d = corridor_graph()
    scale = powerlaw_graph(65536, 3, 16, seed=0)
    return {"human": (human, query_set(human, 8, 16, seed=7)),
            "trap": (trap_d, [trap_q] * 8),
            "corridor": (corr_d, [corr_q, corr_q]),
            "wedge": (trap_d, [trap_q] * 2),
            "scale": (scale, query_set(scale, 8, 32, seed=7))}


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
    """Run the workloads through the port's QueryServer on ``dev``. Each
    kernel's launch count is set to 0 just before a workload and read
    just after it. ``capture`` maps a workload to ``(engine_step
    attribute, wrapper)``: the wrapper records that run's refine inputs
    (it copies them and launches no kernel). Returns per-workload
    results and scheduler figures."""
    import torch
    from repro_torch.core import engine_step
    from repro_torch.kernels import bitmap_refine
    from repro_torch.serving import QueryServer

    out = {}
    for name, (data, queries) in wl.items():
        srv = QueryServer(data, backend="engine", device=dev, **KNOBS[name])
        attr, wrap = (capture or {}).get(name, (None, None))
        real = getattr(engine_step, attr) if attr else None
        if attr:
            setattr(engine_step, attr, wrap(real))
        try:
            bitmap_refine.LAUNCHES = 0
            bitmap_refine.HIER_LAUNCHES = 0
            t0 = time.perf_counter()
            if name == "corridor":
                res = [srv.submit(i, q) for i, q in enumerate(queries)]
            else:
                res = srv.submit_batch(queries)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"dense": bitmap_refine.LAUNCHES,
                        "hier": bitmap_refine.HIER_LAUNCHES}
        finally:
            if attr:
                setattr(engine_step, attr, real)
        sched = srv.scheduler
        out[name] = {"results": res, "wall_s": wall,
                     "slo": srv.slo_report(), "launches": launches,
                     "variant": sched.adjacency_variant,
                     "iterations": sched.timing["iterations"],
                     "readback_s": sched.timing["readback_s"],
                     "readbacks": sched.timing["readbacks"],
                     "dispatches": sched.n_dispatches,
                     "dispatch_s": sched.t_dispatch_s,
                     "exports": sched.n_exported}
    return out


def check_launches(run) -> dict:
    """Each workload went through the kernel of its layout, once per
    megastep iteration, and never through the other one."""
    for name, r in run.items():
        want = "hier" if name == "scale" else "dense"
        other = "dense" if want == "hier" else "hier"
        require(r["variant"] == ("hier-hbm" if want == "hier"
                                 else "dense-vmem"),
                f"{name}: adjacency layout {r['variant']}")
        require(r["launches"][want] > 0, f"{name}: the {want} refine "
                "kernel was never launched")
        require(r["launches"][want] == r["iterations"],
                f"{name}: {want} refine launches {r['launches'][want]} != "
                f"megastep iterations {r['iterations']}")
        require(r["launches"][other] == 0,
                f"{name}: {r['launches'][other]} {other} refine launches")
    return {k: sum(r["launches"][k] for r in run.values())
            for k in ("dense", "hier")}


def check_answers(run, wl) -> None:
    from repro_torch.core.backtrack import backtrack_deadend
    for name in LIMITED:
        data, queries = wl[name]
        for i, (q, r) in enumerate(zip(queries, run[name]["results"])):
            require(r.status in ("ok", "limit"), f"{name} q{i}: {r.status}")
            require(all(valid_embedding(e, q, data) for e in r.embeddings),
                    f"{name} q{i}: invalid embedding row")
            require(len(emb_set(r.embeddings)) == len(r.embeddings),
                    f"{name} q{i}: duplicate embedding")
            want = len(backtrack_deadend(q, data, limit=1000).embeddings)
            require(len(r.embeddings) == want, f"{name} q{i}: "
                    f"{len(r.embeddings)} embeddings, oracle {want}")
    for name in ("trap", "corridor", "wedge"):
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
    require(run["wedge"]["exports"] >= 1,
            "wedge: no device stack was exported to host segments")


def run_digest(run) -> dict:
    """What the kernel and plain runs must agree on, per workload and
    query: embedding set and the prune / row / store counters."""
    return {name: [(sorted(emb_set(r.embeddings)),
                    {k: int(getattr(r.stats, k)) for k in
                     ("deadend_prunes", "rows_created", "patterns_stored")})
                   for r in w["results"]]
            for name, w in run.items()}


def same_runs(a: dict, b: dict) -> None:
    require(a.keys() == b.keys(), "kernel and plain runs: workloads differ")
    for name in a:
        require(len(a[name]) == len(b[name]), f"{name}: query counts differ")
        for i, ((ea, ca), (eb, cb)) in enumerate(zip(a[name], b[name])):
            require(ea == eb, f"{name} q{i}: kernel and plain runs differ")
            for k in ca:
                require(ca[k] == cb[k], f"{name} q{i}: {k} differs between "
                        "kernel and plain runs")


def run_summary(run) -> dict:
    """Per-workload figures: wall time, qps, latency, dispatches and
    iterations."""
    out = {}
    for name, w in run.items():
        slo = w["slo"]
        out[name] = {
            "queries": len(w["results"]), "wall_s": w["wall_s"],
            "qps": len(w["results"]) / w["wall_s"],
            "p50_ms": slo["p50_ms"], "p99_ms": slo["p99_ms"],
            "dispatches": w["dispatches"],
            "mean_dispatch_ms": 1e3 * w["dispatch_s"] / max(
                1, w["dispatches"]),
            "loop_iterations": w["iterations"],
            "wall_ms_per_iteration": 1e3 * w["wall_s"] / max(
                1, w["iterations"]),
            "wedge_exports": w["exports"], "readbacks": w["readbacks"],
            "readback_share": w["readback_s"] / w["wall_s"],
            "found": sum(len(r.embeddings) for r in w["results"]),
            "prunes": sum(r.stats.deadend_prunes for r in w["results"]),
            "launches": w["launches"], "variant": w["variant"]}
        if name == "scale":
            out[name]["adjacency_bytes"] = slo["adjacency_bytes"]
            out[name]["chunk_words"] = slo["chunk_words"]
    return out


# ----------------------------------------------------------------------
# phases 5/6: captured main-path inputs — hier against dense, timing
# ----------------------------------------------------------------------
def sampler(samples: list, n_copied: int):
    """Wrap a refine function so it keeps a uniform sample (reservoir,
    seeded) of the inputs it is called with; the last ``n_copied``
    arguments (the per-call rows) are cloned, the graph lanes before
    them are kept by reference."""
    rng = random.Random(0)
    seen = [0]

    def wrap(real):
        def recorded(*args):
            k = seen[0]
            seen[0] += 1
            j = k if k < N_SAMPLES else rng.randrange(k + 1)
            if j < N_SAMPLES:           # copy only the inputs kept
                cut = len(args) - n_copied
                item = (*args[:cut], *(a.clone() for a in args[cut:]))
                if j == len(samples):
                    samples.append(item)
                else:
                    samples[j] = item
            return real(*args)
        return recorded
    return wrap


def bound_of(adj, cand, frontier, active) -> tuple[float, float]:
    """Least time (ms) for one dense call on these inputs, as (bytes,
    ops): each input byte read once (of the adjacency, only the rows
    these inputs reference), each output byte written once, over the HBM
    rate; one AND per gathered word over the 32-bit rate."""
    import torch
    f, w = cand.shape
    use = (active != 0) & (frontier >= 0)
    rows = torch.unique(frontier[use].clamp(max=adj.shape[0] - 1)).numel()
    nbytes = 4 * (2 * f * w + frontier.numel() + active.numel() + rows * w)
    ops = int(use.sum()) * w
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT_OPS_PER_S


def hier_bound_of(summary, chunk_ptr, chunk_id, chunk_data, kmax, cand,
                  frontier, active) -> tuple[float, float, dict]:
    """Least time (ms) for one hierarchical call on these inputs, as
    (bytes, ops, counts). Bytes, each read once: cand, frontier, active
    and the output; the summary row and the two ``chunk_ptr`` words of
    each distinct active vertex; of each distinct in-range vertex that an
    active position of a live row (summary intersection not all dead)
    holds, its ``chunk_id`` window; and the C words of each distinct
    stored chunk that such a row finds live. Ops: an OR per cand word for
    its chunk summary, an AND per summary word per active position, an
    AND per output word for the dead-chunk mask, and an AND per word of
    each (row, position, live chunk) triple."""
    import torch
    from repro_torch.kernels.ref import summary_intersect_ref
    v, sw = summary.shape
    c = chunk_data.shape[1]
    f, w = cand.shape
    use = (active != 0) & (frontier >= 0)
    verts = torch.unique(frontier[use].clamp(max=v - 1)).numel()
    sacc = summary_intersect_ref(summary, cand, frontier, active, c)
    live_row = (sacc != 0).any(dim=1)
    walk = use & (frontier < v) & live_row[:, None]
    rows, pos = walk.nonzero(as_tuple=True)
    vtx = frontier[rows, pos].long()
    k0 = chunk_ptr[vtx].long()
    nk = chunk_ptr[vtx + 1].long() - k0
    win = torch.arange(kmax, device=cand.device)
    ks = k0[:, None] + win[None, :]
    stored = win[None, :] < nk[:, None]
    cid = chunk_id[ks].long()
    bit = (sacc[rows][torch.arange(len(rows), device=cand.device)[:, None],
                      cid // 32] >> (cid % 32)) & 1
    live = stored & (bit != 0)
    walked_verts = torch.unique(vtx)
    id_words = int((chunk_ptr[walked_verts + 1]
                    - chunk_ptr[walked_verts]).sum())
    chunks = torch.unique(ks[live]).numel()
    nbytes = 4 * (2 * f * w + frontier.numel() + active.numel()
                  + verts * (sw + 2) + id_words + chunks * c)
    triples = int(live.sum())
    ops = 2 * f * w + int(use.sum()) * sw + triples * c
    counts = {"live_rows": int(live_row.sum()), "walked_positions":
              len(rows), "live_chunk_reads": triples,
              "distinct_live_chunks": chunks, "bytes": nbytes}
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT_OPS_PER_S, counts


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
    ms = start.elapsed_time(end) / (TIMING_REPS * len(samples))
    del graph
    torch.cuda.empty_cache()
    return ms


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


def hier_against_dense(samples, data) -> dict:
    """The hierarchical kernel against the dense kernel on the dense
    bitmap of the same graph, on captured scale-run inputs (frontier
    values there lie in [-1, V), where the two layouts agree)."""
    import torch
    from repro_torch.kernels.bitmap_refine import (refine_bitmap_rows,
                                                   refine_bitmap_rows_hier)
    adj = torch.from_numpy(data.adj_bitmap.view("int32")).to(
        samples[0][5].device)
    for s in samples:
        hier = refine_bitmap_rows_hier(*s)
        dense = refine_bitmap_rows(adj, *s[5:])
        require(torch.equal(hier, dense), "hier kernel != dense kernel on "
                "a captured scale input")
    out = {"samples": len(samples), "dense_bitmap_bytes": adj.numel() * 4,
           "equal": True}
    del adj
    torch.cuda.empty_cache()
    return out


def time_hier_kernel(samples) -> dict:
    """Hierarchical kernel and plain version on captured scale inputs.
    The plain version is given its position bound (the deepest active
    position, read here beforehand) so that it can be captured into a
    CUDA graph."""
    import torch
    from repro_torch.kernels.bitmap_refine import refine_bitmap_rows_hier
    from repro_torch.kernels.ref import refine_bitmap_rows_hier_ref
    worst = 0
    for s in samples:
        got = refine_bitmap_rows_hier(*s)
        want = refine_bitmap_rows_hier_ref(*s)
        worst = max(worst, int((got.long() - want.long()).abs().max()))
        require(torch.equal(got, want),
                "hier kernel != plain on a captured scale input")
    bounds = [hier_bound_of(*s) for s in samples]
    t_bytes = sum(b[0] for b in bounds) / len(bounds)
    t_ops = sum(b[1] for b in bounds) / len(bounds)
    counts = {k: sum(b[2][k] for b in bounds) / len(bounds)
              for k in bounds[0][2]}

    def positions(s):
        v = s[0].shape[0]
        act = (s[7] != 0) & (s[6] >= 0) & (s[6] < v)
        cols = act.any(dim=0).nonzero()
        return int(cols.max()) + 1 if cols.numel() else 0
    with_pos = [(*s, positions(s)) for s in samples]

    def plain(*s):
        return refine_bitmap_rows_hier_ref(*s[:-1], positions=s[-1])
    timed = samples[:N_TIMED_HIER]
    return {"ms": device_ms(refine_bitmap_rows_hier, timed),
            "eager_ms": eager_ms(refine_bitmap_rows_hier, timed),
            "plain_ms": device_ms(plain, with_pos[:N_TIMED_HIER]),
            "plain_eager_ms": eager_ms(refine_bitmap_rows_hier_ref, timed),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
            "max_abs_err": worst, "samples_checked": len(samples),
            "samples_timed": len(timed), "per_call": counts,
            "shape": list(samples[0][5].shape),
            "summary_words": int(samples[0][0].shape[1]),
            "chunk_words": int(samples[0][3].shape[1]),
            "kmax": int(samples[0][4])}


def profile_window(dev, wl, name: str, steps: int = 10) -> dict:
    """Where a dispatch of workload ``name`` spends its time:
    ``torch.profiler`` (CPU and CUDA) over ``steps`` scheduler steps of
    its first 8 queries — kernel
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

    data, queries = wl[name]
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
    """CUDA context and first launches of both kernels' paths, outside
    every counted run."""
    from repro_torch.data.graph_gen import powerlaw_graph, query_set
    from repro_torch.serving import QueryServer
    serve(dev, {"corridor": wl["corridor"]})
    small = powerlaw_graph(512, 3, 4, seed=1)
    QueryServer(small, backend="engine", device=dev, hier_adjacency=True
                ).submit_batch(query_set(small, 4, 2, seed=1))


def plain_run(out_path: str) -> int:
    """Phase 4, in its own process: every workload with the plain
    refines forced on the card. Writes the run's digest and summary."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import bitmap_refine
    from repro_torch.kernels.config import backend_scope
    dev = torch.device("cuda")
    wl = workloads()
    with backend_scope("torch"):
        warm_up(dev, wl)
        run = serve(dev, wl)
    require(all(r["launches"] == {"dense": 0, "hier": 0}
                for r in run.values()),
            "a kernel launched under backend_scope('torch')")
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


def kernel_row(name, source, replaces, launches, worst, timing) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(worst, timing["max_abs_err"]),
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": None}


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

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    info("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    info("build", **build_kernels())

    with tempfile.TemporaryDirectory() as tmp:
        plain_path = str(Path(tmp) / "plain_run.pkl")
        proc = start_plain_run(plain_path)
        try:
            wl = workloads()
            human, scale = wl["human"][0], wl["scale"][0]
            worst = check_kernel(dev, kernel_cases(
                human.adj_bitmap.view("int32")))
            worst_hier = check_hier_kernel(dev, hier_cases(scale))
            warm_up(dev, wl)
            samples: list = []
            hier_samples: list = []
            run_k = serve(dev, wl, capture={
                "human": ("refine_bitmap_rows", sampler(samples, 3)),
                "scale": ("refine_bitmap_rows_hier",
                          sampler(hier_samples, 3))})
            launches = check_launches(run_k)
            check_answers(run_k, wl)
            info("serve-kernel", launches=launches, **run_summary(run_k))
            plain = finish_plain_run(proc, plain_path)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    same_runs(run_digest(run_k), plain["digest"])
    info("serve-plain", identical=True, **plain["summary"])

    info("hier-vs-dense", **hier_against_dense(hier_samples, scale))
    timing = time_kernel(samples)
    info("kernel-time", **timing)
    timing_hier = time_hier_kernel(hier_samples)
    info("hier-kernel-time", **timing_hier)
    for name in ("human", "scale"):
        prof = profile_window(dev, wl, name)
        if prof["profiled"]:
            r = run_k[name]
            wall_ms = 1e3 * r["wall_s"] / max(1, r["iterations"])
            prof["main_run_wall_ms_per_iteration"] = wall_ms
            prof["device_busy_share_est"] = \
                prof["device_ms_per_iteration"] / wall_ms
        info(f"profile-{name}", **prof)
    rows = [kernel_row("refine_bitmap_rows",
                       "src/repro_torch/kernels/csrc/bitmap_refine.cu",
                       "src/repro/kernels/bitmap_refine.py:100",
                       launches["dense"], worst, timing),
            kernel_row("refine_bitmap_rows_hier",
                       "src/repro_torch/kernels/csrc/bitmap_refine_hier.cu",
                       "src/repro/kernels/bitmap_refine.py:323",
                       launches["hier"], worst_hier, timing_hier)]
    seconds = time.perf_counter() - t_start
    info("done", seconds=seconds, within_600_s=seconds <= 600)
    print(json.dumps({"kernels": rows}))
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
