"""End-to-end serving driver on the PyTorch port (twin of
``examples/serve_queries.py``): a batched subgraph-matching workload
served through the request/handle API, many concurrent queries packed
into each device wave, with SLO, wave-occupancy and TTFE reporting. One
heavy query rides the same batch with ``parallelism=8``
(shard-as-segments): its root space splits into 8 root segments that
share one slot-private Δ table and steal work from each other, and the
run prints per-shard row/item/steal stats. A streaming demo consumes a
trap query through ``MatchHandle.stream()`` and cancels a second
submission mid-flight; a distributed trap match with full Δ sharing
closes the demo. The engine runs on the card unless ``--device cpu`` is
given.

    PYTHONPATH=src python examples/serve_queries_torch.py [--n-queries 50]

With ``--server host:port`` the same workload is driven through a live
port server instead of an in-process ``QueryServer``: the client reads
the resident graph's generator recipe from ``/healthz``, rebuilds the
identical graph locally to craft valid queries, then streams them over
the NDJSON wire:

    PYTHONPATH=src python -m repro_torch.server.launch --port 8421 &
    PYTHONPATH=src python examples/serve_queries_torch.py --server \\
        127.0.0.1:8421 --n-queries 20

Each part is a function that prints its lines and returns its results,
so that tests and ``chip_smoke.py`` check values, not text. The port has
no serving baseline of its own on the card yet, so no delta is printed
(``BENCH_serving.json`` holds the JAX package's CPU figures).
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

from repro_torch.core.backtrack import _prepare
from repro_torch.core.distributed import DistributedMatcher
from repro_torch.data.graph_gen import (query_set, random_walk_query,
                                        trap_graph, yeast_like_graph)
from repro_torch.serving import QueryServer

NO_BASELINE = ("baseline: none for the port yet (BENCH_serving.json holds "
               "the JAX package's CPU figures) - no delta")


def heavy_query(data):
    """A short walk query with the widest root-candidate range (the
    min-candidate matching order keeps typical roots narrow, so pick the
    fattest search tree worth splitting across shards)."""
    return max((random_walk_query(data, 3, seed=s) for s in range(8)),
               key=lambda q: len(_prepare(q, data, None, None)[0][0]))


def batched_workload(data, n_queries: int, query_size: int,
                     backend: str = "engine", device="cuda",
                     time_budget_s: float = 2.0, **knobs) -> dict:
    """Serve ``n_queries`` random-walk queries plus the heavy query (as
    8 shards) in one batch at limit 1000 and ``time_budget_s`` a query,
    after a warm-up batch. Returns the queries, the results, the SLO
    report, the wall seconds and qps."""
    queries = query_set(data, query_size, n_queries, seed=42)
    heavy = heavy_query(data)
    heavy_i = len(queries)
    queries = queries + [heavy]
    par = [1] * len(queries)
    par[heavy_i] = 8

    # warm-up: the first dispatches of each shape pay one-time costs
    # that would eat the per-query time budgets
    warm = queries[:min(4, len(queries))] + [heavy]
    QueryServer(data, backend=backend, limit=100, time_budget_s=60.0,
                device=device, **knobs).submit_batch(
                    warm, parallelism=[1] * (len(warm) - 1) + [8])
    server = QueryServer(data, backend=backend, limit=1000,
                         time_budget_s=time_budget_s, device=device,
                         **knobs)
    engine = {}
    if backend == "engine":
        sch = server.scheduler
        tun = sch.tuning_record
        engine = {"source": tun["source"], "n_slots": sch.n_slots,
                  "wave_size": sch.wave_size,
                  "megastep_depth": sch.megastep_depth,
                  "pattern_capacity": sch.pattern_capacity}
        print(f"engine config: {tun['source']}"
              f"{' ' + tun['record'] if tun['record'] else ''} -> "
              f"n_slots={sch.n_slots} wave_size={sch.wave_size} "
              f"megastep_depth={sch.megastep_depth} "
              f"pattern_capacity={sch.pattern_capacity}")
    t0 = time.perf_counter()
    results = server.submit_batch(queries, parallelism=par)
    wall = time.perf_counter() - t0
    found = sum(r.n_found for r in results)
    dnf = sum(r.timed_out for r in results)
    capped = sum(r.status == "limit" for r in results)
    qps = len(results) / wall if wall > 0 else 0.0
    print(f"served {len(results)} queries: {found} embeddings total, "
          f"{capped} hit the limit, {dnf} timed out ({qps:.1f} qps)")
    rep = server.slo_report()
    line = (f"SLO: p50={rep['p50_ms']:.1f}ms p99={rep['p99_ms']:.1f}ms "
            f"mean={rep['mean_ms']:.1f}ms")
    if backend == "engine":
        line += (f" | waves={rep['waves']} "
                 f"megastep_depth={rep['megastep_depth']} "
                 f"occupancy={rep['mean_occupancy']:.2f} "
                 f"(steady {rep['steady_occupancy']:.2f}) "
                 f"peak_concurrent={rep['peak_active']} "
                 f"prune_rate={rep['prune_rate']:.2f}")
    print(line)
    if backend == "engine":
        hs = results[heavy_i].stats
        total = max(1, hs.rows_created)
        occ = [f"{r / total:.0%}" for r in (hs.shard_rows or [])]
        print(f"heavy query #{heavy_i} (parallelism=8): "
              f"{hs.rows_created} rows, {hs.steals} steals | per-shard "
              f"rows {hs.shard_rows} (occupancy {occ}) "
              f"items {hs.shard_items}")
    print(NO_BASELINE)
    return {"queries": queries, "results": results, "heavy_i": heavy_i,
            "report": rep, "wall_s": wall, "qps": qps, "engine": engine,
            "found": found, "capped": capped, "timed_out": dnf}


def stream_demo(device="cuda", n: int = 60) -> dict:
    """Streaming and cancellation (request/handle API): the trap query
    keeps emitting embeddings while its dead-end subtrees are still
    resolving, so the first streamed batch lands before retirement; a
    second submission is cancelled mid-flight without touching its
    neighbours."""
    tq, tg = trap_graph(n_b=n, n_c=n, n_good=2, tail_len=2)
    sserver = QueryServer(tg, backend="engine", limit=None, n_slots=4,
                          wave_size=128, kpr=8, device=device)
    handle = sserver.submit_async(tq, limit=None)
    rows = []
    n_batches = 0
    for batch in handle.stream():           # [k, n_query] int32 batches
        rows.extend(batch)
        n_batches += 1
    res = handle.result()
    print(f"\nstreamed trap query: {len(rows)} embeddings over "
          f"{n_batches} batches; TTFE {res.ttfe_s * 1e3:.0f}ms vs "
          f"completion {res.latency_s * 1e3:.0f}ms ({res.status})")
    doomed = sserver.submit_async(tq, limit=None)
    for _ in doomed.stream():
        doomed.cancel()                     # evict after the first batch
    dres = doomed.result()
    print(f"cancelled mid-flight: status={dres.status}, kept "
          f"{dres.n_found} partial embeddings")
    return {"query": tq, "data": tg, "rows": rows, "n_batches": n_batches,
            "status": res.status, "ttfe_s": res.ttfe_s,
            "latency_s": res.latency_s, "cancelled_status": dres.status,
            "cancelled_rows": list(dres.embeddings)}


def distributed_trap(device="cuda", n: int = 120) -> dict:
    """Distributed matching of one hard query: shard-as-segments with
    full Δ sharing (every mu learned by one shard prunes the others)."""
    q, g = trap_graph(n_b=n, n_c=n, n_good=2, tail_len=2)
    dm = DistributedMatcher(g, n_shards=4, wave_size=128, kpr=8,
                            device=device)
    res = dm.match(q, limit=None)
    print(f"\ndistributed trap({n}): {res.stats.found} embeddings, "
          f"{res.stats.recursions} rows across 4 shards, "
          f"{res.stats.deadend_prunes} prunes (full Δ shared), "
          f"{res.stats.steals} steals, per-shard rows "
          f"{res.stats.shard_rows}")
    return {"query": q, "data": g, "found": res.stats.found,
            "rows": res.stats.recursions,
            "prunes": res.stats.deadend_prunes, "steals": res.stats.steals,
            "shard_rows": res.stats.shard_rows,
            "embeddings": res.embeddings}


def run_against_server(target: str, n_queries: int,
                       query_size: int) -> dict:
    """Drive the workload through a live port server over HTTP: rebuild
    the server's resident graph from the generator recipe on
    ``/healthz``, stream one query (TTFE vs completion), then run the
    rest through the blocking client and print the server-side SLO
    gauges. Returns the graph, the queries, every query's rows and
    terminal result, and the SLO."""
    from repro_torch.server.client import ServeClient
    from repro_torch.server.server_args import ServerArgs

    host, _, port = target.rpartition(":")
    cli = ServeClient(host or "127.0.0.1", int(port))
    health = cli.health()
    gi = health["graph"]
    print(f"server {target}: graph={gi['kind']} |V|={gi['n_vertices']} "
          f"|E|={gi['n_edges']} labels={gi['n_labels']} "
          f"draining={health['draining']}")
    data = ServerArgs(graph=gi["kind"], graph_n=gi["n"],
                      graph_m=gi["m"], graph_labels=gi["labels"],
                      graph_extra_edges=gi["extra_edges"],
                      graph_seed=gi["seed"]).build_graph()
    assert data.n == gi["n_vertices"], "graph recipe mismatch"
    queries = query_set(data, query_size, max(n_queries, 2), seed=42)

    # one streamed query: embeddings arrive while the search is still
    # backtracking, as MatchHandle.stream() gives them in-process
    rows0 = []
    n_chunks = 0
    ttfe = None
    t0 = time.perf_counter()
    for ev in cli.stream(queries[0], tenant="example"):
        if ev["event"] == "chunk" and ev["rows"]:
            if n_chunks == 0:
                ttfe = time.perf_counter() - t0
            n_chunks += 1
            rows0.extend(ev["rows"])
        elif ev["event"] == "done":
            done = ev["result"]
    wall = time.perf_counter() - t0
    print(f"streamed query 0: {len(rows0)} embeddings over {n_chunks} "
          f"chunks; TTFE {(ttfe or 0.0) * 1e3:.0f}ms vs completion "
          f"{wall * 1e3:.0f}ms ({done['status']})")

    rows, results = [rows0], [done]
    t0 = time.perf_counter()
    statuses: dict[str, int] = {}
    for i, q in enumerate(queries[1:], start=1):
        r, res = cli.match(q, tenant="example", request_id=i)
        statuses[res["status"]] = statuses.get(res["status"], 0) + 1
        rows.append(r)
        results.append(res)
    wall = time.perf_counter() - t0
    n = len(queries) - 1
    found = sum(len(r) for r in rows[1:])
    qps = n / wall if wall > 0 else 0.0
    print(f"served {n} blocking queries over the wire: {found} "
          f"embeddings, statuses={statuses} ({qps:.1f} qps)")
    slo = cli.slo()
    print(f"server SLO: queue_depth={slo['queue_depth']} "
          f"resident={slo['resident_queries']} "
          f"backpressure_absorbed={slo['backpressure_absorbed']}"
          + (f" p50={slo['p50_ms']:.1f}ms p99={slo['p99_ms']:.1f}ms"
             if "p50_ms" in slo else ""))
    return {"data": data, "queries": queries, "rows": rows,
            "results": results, "statuses": statuses, "qps": qps,
            "ttfe_s": ttfe, "slo": slo}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-queries", type=int, default=50)
    ap.add_argument("--query-size", type=int, default=10)
    ap.add_argument("--backend", default="engine",
                    choices=["sequential", "engine"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--server", default=None, metavar="HOST:PORT",
                    help="drive a live repro_torch.server.launch process "
                         "over HTTP instead of the in-process engine")
    # default None, not a number: leave unset to let the engine resolve
    # MatchOptions > tuning cache > built-in default
    ap.add_argument("--n-slots", type=int, default=None,
                    help="concurrent queries resident per wave (engine); "
                         "default: tuned/built-in resolution")
    ap.add_argument("--wave-size", type=int, default=None,
                    help="rows per device wave; default: tuned/built-in "
                         "resolution")
    args = ap.parse_args(argv)
    if args.server is not None:
        return {"server": run_against_server(args.server, args.n_queries,
                                             args.query_size)}
    knobs = {k: v for k, v in (("n_slots", args.n_slots),
                               ("wave_size", args.wave_size))
             if v is not None}

    data = yeast_like_graph(0)
    print(f"data graph: |V|={data.n} |E|={data.n_edges} "
          f"labels={data.n_labels}")
    return {"data": data,
            "batch": batched_workload(data, args.n_queries,
                                      args.query_size, args.backend,
                                      args.device, **knobs),
            "stream": stream_demo(args.device),
            "distributed": distributed_trap(args.device)}


if __name__ == "__main__":
    main()
