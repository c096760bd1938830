"""Measurement harness for the port's autotuner.

Two granularities, each with untimed warmup runs (the first launch on a
card builds the kernel library and its context) and the median of the
timed trials, so one GC pause or host hiccup cannot crown a candidate:

* :func:`refine_microbench` — ``refine_bitmap_rows`` alone on synthetic
  operands of the target shape, on the device's tensors;
* :func:`run_smoke_workload` — the serving smoke uniform workload (the
  reference's ``SMOKE_SHAPE``, built by the port's generators) end to
  end through a :class:`WaveScheduler` built with the candidate's
  knobs, returning qps, the per-slot store load factor, and a digest
  over the sorted embedding rows. The digest is the tuner's safety
  interlock: every candidate must produce bit-identical embeddings
  (configuration may move time, never results). Its formula is the
  reference's, so both packages give the same hex digest for the same
  embeddings.

Every clock read on a card follows a device synchronise: a CUDA call
returns before the card has done its work.
"""
from __future__ import annotations

import hashlib
import statistics
import time

__all__ = ["timed_trials", "refine_microbench", "run_smoke_workload",
           "SMOKE_SHAPE"]

# The serving smoke workload's construction parameters (the reference's
# ``repro.tuning.measure.SMOKE_SHAPE``, the ``benchmarks/serving_bench.py
# --smoke`` uniform leg).
SMOKE_SHAPE = {
    "n_vertices": 128, "extra_edges": 128, "n_labels": 24,
    "n_queries": 8, "query_size": 4, "kpr": 8,
    "limit": 1000, "time_budget_s": 10.0, "graph_seed": 0,
    "query_seed": 7,
}


def _sync_fn(device):
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def timed_trials(fn, warmup: int = 1, trials: int = 3,
                 device=None) -> float:
    """Median wall seconds of ``trials`` calls after ``warmup`` untimed
    ones. On a CUDA ``device`` the device is synchronised before each
    clock read."""
    sync = _sync_fn(device) if device is not None else (lambda: None)
    for _ in range(max(0, warmup)):
        fn()
    samples = []
    for _ in range(max(1, trials)):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def refine_microbench(backend: str | None, block_f: int,
                      n_vertices: int = 128, f: int = 64, np_: int = 8,
                      warmup: int = 1, trials: int = 3, seed: int = 0,
                      device="cuda") -> float:
    """Median seconds of one ``refine_bitmap_rows`` call on synthetic
    operands shaped like the target workload, on ``device``. ``block_f``
    is accepted for parity with the reference: no CUDA kernel reads it."""
    import numpy as np
    import torch

    from ..core.graph import pack_bitmap
    from ..kernels.bitmap_refine import refine_bitmap_rows
    from ..kernels.config import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    dense = rng.random((n_vertices, n_vertices)) < 0.2
    dense |= dense.T

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    adj = put(pack_bitmap(dense).view(np.int32))
    cand = put(pack_bitmap(rng.random((f, n_vertices)) < 0.5
                           ).view(np.int32))
    frontier = put(rng.integers(-1, n_vertices, size=(f, np_))
                   .astype(np.int32))
    active = put((rng.random((f, np_)) < 0.6).astype(np.int32))

    def call():
        refine_bitmap_rows(adj, cand, frontier, active, backend=backend)

    return timed_trials(call, warmup=warmup, trials=trials, device=dev)


def _embeddings_digest(finished: dict) -> str:
    """sha256 over every query's sorted embedding rows — the
    bit-identity interlock across candidate configurations (the
    reference's formula)."""
    import numpy as np

    h = hashlib.sha256()
    for qid in sorted(finished):
        rows = sorted(
            np.asarray(e, np.int32).tobytes()
            for e in finished[qid].embeddings)
        h.update(str(qid).encode())
        for r in rows:
            h.update(r)
    return h.hexdigest()


def smoke_workload():
    """The smoke workload's data graph and queries (port generators)."""
    from ..data.graph_gen import ba_labeled_graph, query_set
    s = SMOKE_SHAPE
    data = ba_labeled_graph(s["n_vertices"], 3, s["n_labels"],
                            extra_edges=s["extra_edges"],
                            seed=s["graph_seed"])
    return data, query_set(data, s["query_size"], s["n_queries"],
                           seed=s["query_seed"])


def run_smoke_workload(params: dict, backend: str | None = None,
                       warmup: int = 1, trials: int = 2,
                       device="cuda") -> dict:
    """End-to-end measurement of one candidate configuration on the
    serving smoke uniform workload, on ``device``.

    ``params`` is a ``CandidateConfig.as_params()`` dict — the engine
    knobs are passed *explicitly* to :class:`MatchOptions` (so the
    measurement is independent of whatever the cache currently holds)
    and the kernel-layout knobs are pinned through
    ``kernels.config.kernel_param_scope``. ``backend`` forces the
    kernels' backend for the run (None: the device's).
    """
    from ..api.options import MatchOptions
    from ..core.vectorized import WaveScheduler
    from ..kernels import config as kconfig

    s = SMOKE_SHAPE
    dev = kconfig.resolve_device(device)
    sync = _sync_fn(dev)
    data, queries = smoke_workload()
    opts = MatchOptions(
        limit=s["limit"], time_budget_s=s["time_budget_s"], kpr=s["kpr"],
        n_slots=params["n_slots"], wave_size=params["wave_size"],
        megastep_depth=params["megastep_depth"],
        stack_capacity=params["stack_capacity"],
        pattern_capacity=params["pattern_capacity"],
        store_flush_min=params["store_flush_min"])

    state: dict = {}
    walls: list[float] = []

    def one_run():
        sched = WaveScheduler(data, options=opts, device=dev)
        for q in queries:
            sched.submit(q)
        sync()
        t0 = time.perf_counter()
        finished = sched.run()
        sync()
        walls.append(time.perf_counter() - t0)
        state["digest"] = _embeddings_digest(finished)
        state["n_embeddings"] = int(
            sum(len(r.embeddings) for r in finished.values()))
        stats = sched.scheduler_stats()
        state["store_load_factor"] = float(stats["store_load_factor"])
        state["prune_rate"] = float(stats["prune_rate"])

    # kernel-level knobs pin through kernel_param_scope (the engine
    # knobs above went through MatchOptions), so a measured point runs
    # exactly the layout its record would later resolve to
    scope = {k: params[k] for k in ("block_f", "hbm_adjacency",
                                    "chunk_words", "dma_depth")
             if k in params}
    with kconfig.kernel_param_scope(**scope), \
            kconfig.backend_scope(backend or kconfig.get_backend()):
        timed_trials(one_run, warmup=warmup, trials=trials)
    # construction and submit stay outside the timed window; the median
    # is over the serving walls of the timed runs
    wall = statistics.median(walls[max(0, warmup):])
    return {
        "qps": len(queries) / wall if wall > 0 else 0.0,
        "wall_s": wall,
        "digest": state["digest"],
        "n_embeddings": state["n_embeddings"],
        "store_load_factor": state["store_load_factor"],
        "prune_rate": state["prune_rate"],
    }
