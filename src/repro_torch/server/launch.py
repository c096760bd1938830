"""Standalone server process entry point of the port (DESIGN.md §10).

    python -m repro_torch.server.launch --graph ba --graph-n 512 --port 8421
    python -m repro_torch.server.launch --device cpu --port 0

Builds the data graph, constructs the engine on ``--device`` (the card
by default; knobs resolved through ``MatchOptions`` > tuning cache >
built-in), builds the refine kernels and warms the engine, then
announces readiness on stdout with one machine-parseable line:

    REPRO_SERVER_READY {"host": "127.0.0.1", "port": 8421, ...}

(scripts and tests wait for that line before sending traffic). SIGTERM/SIGINT trigger a graceful drain: new requests are
refused with a typed ``draining`` event, queued + resident queries run
to their terminal status (bounded by ``--drain-timeout-s``, then
cancelled through the eviction path), the final SLO report is flushed
to stderr, and the process exits 0. An engine step that raises (a
device fault) ends every request with a ``status="error"`` done event
and the process with exit code 1.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import time

from .server import MatchServer, _jsonify
from .server_args import ServerArgs

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.server.launch",
        description="Subgraph-matching serving tier of the PyTorch port")
    ServerArgs.add_cli_args(ap)
    ap.add_argument("--quiet", action="store_true",
                    help="suppress progress logging on stderr")
    ns = ap.parse_args(argv)
    args = ServerArgs.from_cli_args(ns)

    def log(msg: str) -> None:
        if not ns.quiet:
            print(f"[repro-server] {msg}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    log(f"building data graph: {args.graph} "
        f"(n={args.graph_n}, seed={args.graph_seed})")
    data = args.build_graph()
    log(f"data graph ready: |V|={data.n} |E|={data.n_edges} "
        f"labels={data.n_labels} ({time.perf_counter() - t0:.1f}s)")

    server = MatchServer(data, args, log=log)
    if args.backend == "engine":
        sch = server.qserver.scheduler
        tun = sch.tuning_record
        log(f"engine config: {tun['source']}"
            f"{' ' + tun['record'] if tun.get('record') else ''} -> "
            f"n_slots={sch.n_slots} wave_size={sch.wave_size} "
            f"megastep_depth={sch.megastep_depth}")
    server.warmup()

    # graceful drain on SIGTERM/SIGINT: stop admitting, finish
    # residents, flush the SLO report (handler only flips events — the
    # engine thread owns the actual teardown)
    def _drain(signum, frame):
        log(f"signal {signum}: draining "
            f"(timeout {args.drain_timeout_s:g}s)")
        server.begin_drain()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)

    ready = {"host": server.host, "port": server.port,
             "graph": args.graph, "n_vertices": data.n,
             "backend": args.backend, "device": args.device,
             "tenants": sorted(server.admission.snapshot()),
             "warmup_s": round(time.perf_counter() - t0, 2),
             "baseline_qps": server.baseline_qps}
    print("REPRO_SERVER_READY " + json.dumps(ready), flush=True)
    log(f"listening on http://{server.host}:{server.port}")

    server.serve_forever()             # returns once the drain finishes
    if server.failure is not None:     # resident requests got an error
        print(f"[repro-server] engine failed: {server.failure!r}",
              file=sys.stderr, flush=True)
        return 1

    rep = _jsonify(server.qserver.slo_report())
    rep["wire"] = server.metrics.snapshot(server.admission)["wire"]
    rep["tenants"] = server.admission.snapshot()
    print("REPRO_SERVER_SLO " + json.dumps(rep), file=sys.stderr,
          flush=True)
    log("drained; bye")
    return 0


if __name__ == "__main__":
    sys.exit(main())
