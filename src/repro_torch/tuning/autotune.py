"""Autotune CLI of the port: sweep candidate configurations, verify
bit-identical embeddings across them, and persist the best record.

    PYTHONPATH=src python -m repro_torch.tuning.autotune --smoke
    PYTHONPATH=src python -m repro_torch.tuning.autotune --smoke --device cpu

The default runs on the card (backend ``cuda``, the CUDA kernels);
``--device cpu`` tunes the plain versions on the host (backend
``torch``). ``--smoke`` narrows the knob domains to a handful of points
around the serving smoke shape and always includes the built-in-default
point — so the recorded best is never worse than the defaults on the
machine that measured it. The report (JSON on stdout) lists every
measured point, every rejected point with its reason, and flags
pattern-capacity points whose store load factor stayed below
``LOAD_FACTOR_FLOOR``.

The tuner refuses to write a record if any candidate's embedding digest
deviates: a tuned configuration may move time, never results.
"""
from __future__ import annotations

import argparse
import json
import sys

from .cache import TuningCache, device_kind
from .measure import SMOKE_SHAPE, refine_microbench, run_smoke_workload
from .space import CandidateConfig, TunableSpace, WorkloadShape, \
    schema_hash

__all__ = ["autotune", "LOAD_FACTOR_FLOOR", "SMOKE_DOMAINS",
           "FULL_DOMAINS"]

# a capacity point whose max store load factor stays below this after
# the whole workload is oversized for that workload
LOAD_FACTOR_FLOOR = 0.05

# Smoke-mode knob domains (the reference's): pinned to the serving smoke
# packing shape (wave 64 / 8 slots) and sweeping the knobs the smoke
# bench leaves to the tuner. The built-in default point is in the cross
# product by construction. ``block_f`` stays pinned at 8 on every
# backend: no port kernel reads it.
SMOKE_DOMAINS = {
    "block_f": [8],
    "megastep_depth": [4, 6, 8],
    "wave_size": [64],
    "n_slots": [8],
    "stack_capacity": [1024],
    "pattern_capacity": [512, 1024],
    "store_flush_min": [16],
    # adjacency layout pinned dense at the smoke shape (128 vertices is
    # far below the threshold); chunk_words / dma_depth only matter on
    # the hierarchical layout
    "hbm_adjacency": [0],
    "chunk_words": [8],
    "dma_depth": [2],
}

# Full-mode domains: a bounded sweep around the serving defaults.
FULL_DOMAINS = {
    "block_f": [8],
    "megastep_depth": [2, 4, 6, 8],
    "wave_size": [256, 512],
    "n_slots": [8],
    "stack_capacity": [1024],
    "pattern_capacity": [512, 1024, 4096],
    "store_flush_min": [8, 16],
    "hbm_adjacency": [0],
    "chunk_words": [8],
    "dma_depth": [2],
}


def autotune(smoke: bool = True, trials: int = 2, cache_path=None,
             write: bool = True, device="cuda") -> dict:
    """Run the sweep on ``device``; returns the JSON-safe report (and
    persists the best record unless ``write=False``). The backend is
    the device's (``cuda`` on a card, ``torch`` on the CPU, or the one
    ``REPRO_TORCH_KERNEL_BACKEND`` forces), which keys the record."""
    from ..kernels import config as kconfig

    dev = kconfig.resolve_device(device)
    backend = kconfig.device_backend(dev)
    n_vertices = SMOKE_SHAPE["n_vertices"]
    shape = WorkloadShape.for_graph(n_vertices)
    space = TunableSpace(backend, shape)
    domains = dict(SMOKE_DOMAINS if smoke else FULL_DOMAINS)
    candidates = space.candidates(overrides=domains)
    if not candidates:
        raise RuntimeError(
            "no valid candidate points — every point rejected: "
            + "; ".join(r for _, r in space.rejected))

    default_cfg = CandidateConfig()
    measured = []
    for cfg in candidates:
        res = run_smoke_workload(cfg.as_params(), backend=backend,
                                 warmup=1, trials=trials, device=dev)
        measured.append({"params": cfg.as_params(), **res})
        print(f"autotune: {cfg.as_params()} -> "
              f"{res['qps']:.1f} qps "
              f"(load_factor={res['store_load_factor']:.3f})",
              file=sys.stderr)

    # bit-identity interlock: every configuration must enumerate the
    # exact same embedding sets
    digests = {m["digest"] for m in measured}
    if len(digests) != 1:
        raise RuntimeError(
            "embedding digests diverged across candidate configs — "
            "refusing to write a tuning record: "
            + json.dumps([{"params": m["params"], "digest": m["digest"]}
                          for m in measured]))

    best = max(measured, key=lambda m: m["qps"])
    # the smoke default-equivalent point: built-in defaults for the
    # swept knobs at the pinned packing shape
    default_point = next(
        (m for m in measured if all(
            m["params"][k] == getattr(default_cfg, k)
            for k in ("megastep_depth", "pattern_capacity",
                      "stack_capacity", "store_flush_min", "block_f"))),
        None)

    capacity_flags = [
        {"pattern_capacity": m["params"]["pattern_capacity"],
         "store_load_factor": m["store_load_factor"],
         "oversized": m["store_load_factor"] < LOAD_FACTOR_FLOOR}
        for m in measured]

    # the CUDA dense refine's own time at the smoke shape
    micro = None
    if backend == "cuda":
        micro = {
            str(bf): refine_microbench(backend, bf, n_vertices=n_vertices,
                                       trials=trials, device=dev) * 1e3
            for bf in sorted({m["params"]["block_f"] for m in measured})}

    dev_kind = device_kind(dev)
    report = {
        "backend": backend,
        "device_kind": dev_kind,
        "n_vertices": n_vertices,
        "schema_hash": schema_hash(),
        "smoke": bool(smoke),
        "trials": trials,
        "n_candidates": len(candidates),
        "n_rejected": len(space.rejected),
        "rejected": [{"params": cfg.as_params(), "reason": reason}
                     for cfg, reason in space.rejected][:50],
        "measured": [{k: v for k, v in m.items() if k != "digest"}
                     for m in measured],
        "digest": next(iter(digests)),
        "capacity_flags": capacity_flags,
        "refine_microbench_ms": micro,
        "best": {"params": best["params"], "qps": best["qps"]},
        "default_qps": default_point["qps"] if default_point else None,
    }

    if write:
        cache = TuningCache(cache_path)
        rec = cache.put(
            backend, dev_kind, n_vertices, best["params"],
            measured={
                "qps": best["qps"],
                "default_qps": report["default_qps"],
                "store_load_factor": best["store_load_factor"],
                "n_embeddings": best["n_embeddings"],
                "trials": trials,
                "workload": "uniform-smoke-v%d" % n_vertices,
            })
        report["record"] = rec["name"]
        report["cache_path"] = str(cache.path)
        print(f"autotune: wrote {rec['name']} -> {cache.path} "
              f"(best {best['qps']:.1f} qps, default "
              f"{report['default_qps']}, schema {schema_hash()})",
              file=sys.stderr)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning.autotune",
        description="kernel & schedule autotuner of the PyTorch port")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale sweep at the serving smoke shape")
    ap.add_argument("--device", default="cuda",
                    help="device to tune on (default: the card; 'cpu' "
                         "tunes the plain versions)")
    ap.add_argument("--trials", type=int, default=2,
                    help="timed trials per point (median)")
    ap.add_argument("--cache", default=None,
                    help="cache file (default: TUNING_CACHE_TORCH.json at "
                         "the repo root, or REPRO_TORCH_TUNING_CACHE)")
    ap.add_argument("--dry-run", action="store_true",
                    help="measure and report without writing the cache")
    args = ap.parse_args(argv)
    report = autotune(smoke=args.smoke,
                      trials=args.trials, cache_path=args.cache,
                      write=not args.dry_run, device=args.device)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
