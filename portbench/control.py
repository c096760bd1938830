"""The control of the benchmark's comparison: the judge must fail it.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--queries N]

For each seed the cell's data graph and query pool are made as a run
makes them, and the first ``N`` queries of the pool (as many as a run
judges; the traffic file's ``control_queries`` by default) are answered
by the plain reference in the program's place, with one guarantee the
configuration states broken: each query vertex is checked against its
first placed neighbour only, so the query's other edges go unchecked
(``enumerate_embeddings(parent_edge_only=True)``, the shortcut of
refining against a spanning tree). The answers go through the run's own
judge. Prints one JSON line a seed with every number and its limit and
whether the judge passed it; exits 0 only when the judge failed every
seed. Needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.datasets import cache  # noqa: E402
from portbench.harness import ROOT, judge, load_cell, passes  # noqa: E402
from portbench.queries import query_pool  # noqa: E402
from portbench.reference.match import (DataGraph,  # noqa: E402
                                       enumerate_embeddings)


def control_answers(queries, g, limit):
    """The control's answers in the judge's form."""
    out = []
    for i, q in enumerate(queries):
        n, rows = enumerate_embeddings(q, g, limit, keep=True,
                                       parent_edge_only=True)
        status = "limit" if n >= limit else "ok"
        out.append((i, status, n, rows))
    return out


def run_control(workload: str, seed: int, n_queries: int | None = None,
                root: Path = ROOT) -> dict:
    cell = load_cell(workload, root)
    cfg, traffic = cell.config, cell.traffic
    limit = int(cfg["limit"])
    arrays, _ = cache.load(cfg["name"], cfg["graph"],
                           root / "portbench" / ".cache")
    g = DataGraph.of(arrays)
    n = int(n_queries or traffic["control_queries"])
    queries = query_pool(g, int(traffic["query_vertices"]), n, seed)
    t = time.perf_counter()
    checks, failed = judge(control_answers(queries, g, limit), queries, g,
                           limit, missing=0)
    return {"workload": workload, "seed": seed, "queries": n,
            "passed": passes(checks), "failed": failed,
            "seconds": time.perf_counter() - t, "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--queries", type=int, default=None)
    a = p.parse_args(argv)
    results = [run_control(a.workload, s, a.queries) for s in a.seeds]
    for r in results:
        print(json.dumps(r), flush=True)
    return 0 if not any(r["passed"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
