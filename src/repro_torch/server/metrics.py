"""Serving-tier metrics of the port (DESIGN.md §10): the ``/metrics`` +
``/slo`` payloads.

One :class:`ServerMetrics` instance aggregates four layers into a
JSON-safe snapshot:

* **wire-level counters** owned here (requests, protocol rejects,
  streamed chunks/rows, client disconnects, absorbed engine
  backpressure, drain state) — bumped from HTTP handler threads and the
  engine thread under one lock;
* **admission counters** — per-tenant offered/admitted/shed/
  backpressure tallies and instantaneous queue depths, read from the
  :class:`~repro_torch.server.admission.AdmissionController`;
* **engine SLO + scheduler stats** — ``QueryServer.slo_report()``
  (latency/TTFE percentiles, terminal-status tallies, and the
  ``queue_depth``/``resident_queries`` gauges) and
  ``scheduler_stats()`` (fault counters, tuning record, occupancy);
* **kernel launches** — the refine kernels' launch counts since the
  process started (``kernels.bitmap_refine``), so a caller can read how
  many launches its traffic made as the difference of two snapshots.

The engine-side report is refreshed *by the engine thread* (the
scheduler is single-threaded state; ``scheduler_stats`` mutates flush
counters) and cached here, so ``/metrics`` served from an HTTP thread
never races the wave loop.
"""
from __future__ import annotations

import threading
import time

__all__ = ["ServerMetrics", "kernel_launches"]


def kernel_launches() -> dict:
    """The refine kernels' launch counts in this process."""
    from ..kernels import bitmap_refine
    return {"refine_bitmap_rows": bitmap_refine.LAUNCHES,
            "refine_bitmap_rows_hier": bitmap_refine.HIER_LAUNCHES}

# wire-level counter names (all start at 0; JSON ints)
_COUNTERS = (
    "requests_total",          # POST /v1/match bodies received
    "protocol_errors",         # rejected before becoming a query
    "accepted",                # admitted into a tenant queue
    "admission_shed",          # dropped by the bounded-queue policy
    "submitted",               # handed to MatchSession.submit
    "completed",               # terminal done events emitted
    "chunks_streamed",         # chunk events emitted
    "rows_streamed",           # embedding rows across all chunks
    "client_disconnects",      # mid-stream EPIPE -> cancellation
    "backpressure_absorbed",   # QueueFull absorbed + retried
    "draining_rejects",        # requests refused during drain
)


class ServerMetrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters = {k: 0 for k in _COUNTERS}
        self._engine_report: dict = {}
        self._engine_report_t = 0.0
        self.t_start = time.time()
        self.draining = False

    # ------------------------------------------------------------------
    def bump(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters[name]

    # ------------------------------------------------------------------
    def set_engine_report(self, report: dict) -> None:
        """Engine-thread-only: cache the latest slo_report/stats merge
        so HTTP threads never touch live scheduler state."""
        with self._lock:
            self._engine_report = report
            self._engine_report_t = time.time()

    # ------------------------------------------------------------------
    def slo(self) -> dict:
        """The ``/slo`` payload: the engine's own SLO report (latency /
        TTFE percentiles, terminal tallies, queue_depth +
        resident_queries gauges) stamped with its snapshot age."""
        with self._lock:
            rep = dict(self._engine_report)
            rep["snapshot_age_s"] = (time.time() - self._engine_report_t
                                     if self._engine_report_t else None)
            rep["draining"] = self.draining
        return rep

    def snapshot(self, admission=None) -> dict:
        """The ``/metrics`` payload: wire counters + per-tenant
        admission state + the cached engine report."""
        with self._lock:
            out = {
                "uptime_s": time.time() - self.t_start,
                "draining": self.draining,
                "wire": dict(self._counters),
                "engine": dict(self._engine_report),
                "kernel_launches": kernel_launches(),
            }
        if admission is not None:
            out["tenants"] = admission.snapshot()
            out["admission_depth"] = admission.depth
        return out
