"""Batched + streamed subgraph-matching query serving (DESIGN.md §4).

:class:`QueryServer` is a thin *session* over the request/handle API
(:mod:`repro_torch.api`): the paper's evaluation protocol (10 000-query sets,
enumeration capped at 1000 embeddings, per-query time budget) as a
service, plus the interactive scenarios the batch API cannot express —

* :meth:`submit_async` — non-blocking; returns a
  :class:`~repro_torch.api.MatchHandle` with ``done()/result()/cancel()`` and
  ``stream()`` (embedding batches delivered as waves emit them, so time
  to first embedding — TTFE — beats completion latency);
* :meth:`submit` / :meth:`submit_batch` — the legacy blocking
  interfaces, now compatibility wrappers over request/handle;
* priority-aware admission from the bounded queue
  (``MatchOptions.priority``; :class:`~repro_torch.api.QueueFull` is the
  typed backpressure signal);
* :meth:`slo_report` — p50/p99/mean latency, TTFE percentiles, timeout
  tally, and the scheduler's wave/occupancy statistics.

Every knob — per-query (``limit``, ``time_budget_s``,
``max_recursions``, ``parallelism``, ``priority``, …) and per-engine
(``n_slots``, ``wave_size``, ``megastep_depth``, ``pattern_*``, …) —
resolves through :class:`repro_torch.api.MatchOptions`, the single source of
truth; the server adds none of its own defaults.

backend: "engine" (shared-wave PyTorch scheduler) or "sequential" (paper
Algorithm 2 reference, one query at a time — the correctness oracle;
it supports the same handle lifecycle including streaming and
cancellation).
"""
from __future__ import annotations

import numpy as np

from ..api.handle import MatchHandle, QueryResult  # noqa: F401 (re-export)
from ..api.options import MatchOptions
from ..api.session import MatchSession
from ..core.graph import Graph

__all__ = ["QueryServer", "QueryResult"]


class QueryServer:
    """Serve matching queries against one data graph."""

    def __init__(self, data: Graph, backend: str = "sequential",
                 options: MatchOptions | None = None, device="cuda",
                 **knobs):
        """``options`` / ``knobs`` resolve through
        :class:`repro_torch.api.MatchOptions` and configure both the engine
        (``n_slots``, ``wave_size``, ``kpr``, ``megastep_depth``,
        ``max_queue``, ``pattern_capacity``, ``pattern_cache*``, …) and
        the default per-query budget (``limit``, ``time_budget_s``,
        ``max_recursions``) applied to every submission that does not
        override them. The pattern-cache knobs control the cross-query
        template cache: recurring query templates warm-start their Δ
        from the previous run's hot transferable patterns (DESIGN.md
        §6); cache hit/warm-start metrics surface in
        :meth:`slo_report` and per-query in ``QueryResult.stats``.
        ``device`` (default ``"cuda"``) places the engine; without a
        card the default raises."""
        self.data = data
        self.backend = backend
        self.options = MatchOptions.resolve(options, **knobs)
        self.session = MatchSession(
            data, options=self.options, device=device,
            backend="engine" if backend == "engine" else "sequential")
        self.scheduler = self.session.scheduler   # None on sequential
        self.latencies: list[float] = []
        self.ttfes: list[float] = []
        self.n_timeouts = 0
        self.n_cancelled = 0
        self.n_errors = 0
        self.n_shed = 0
        # QueueFull events absorbed by submit_batch's drain-and-retry
        # loop. Backpressure is *not* shedding — the query still runs —
        # but the serving tier needs the count to distinguish "dropped"
        # from "retried later" when sizing admission queues.
        self.n_backpressure = 0
        self.session.on_complete = self._record

    # convenience views of the resolved per-query defaults
    @property
    def limit(self):
        return self.options.limit

    @property
    def time_budget_s(self):
        return self.options.time_budget_s

    @property
    def max_recursions(self):
        return self.options.max_recursions

    # ------------------------------------------------------------------
    def _record(self, qr: QueryResult) -> None:
        """Session completion hook: SLO bookkeeping for every finished
        query, whether consumed via handles or the blocking wrappers."""
        self.latencies.append(qr.latency_s)
        if qr.ttfe_s is not None:
            self.ttfes.append(qr.ttfe_s)
        self.n_timeouts += qr.timed_out
        self.n_cancelled += qr.status == "cancelled"
        self.n_errors += qr.status == "error"
        self.n_shed += qr.status == "shed"

    # ------------------------------------------------------------------
    # request/handle API
    # ------------------------------------------------------------------
    def submit_async(self, query: Graph, *, query_id: int | None = None,
                     options: MatchOptions | None = None,
                     **overrides) -> MatchHandle:
        """Non-blocking submit; returns a :class:`MatchHandle`
        (``done()``, ``result()``, ``stream()``, ``cancel()``).

        Raises :class:`repro_torch.api.QueueFull` when the bounded admission
        queue is at capacity — apply backpressure (``step()`` /
        consume a handle) or shed load. Admission from the queue is
        priority-aware (``priority=`` override, higher first)."""
        return self.session.submit(query, query_id=query_id,
                                   options=options, **overrides)

    def step(self) -> bool:
        """Advance the backend by one unit of work; False when idle."""
        return self.session.step()

    # ------------------------------------------------------------------
    # legacy blocking wrappers
    # ------------------------------------------------------------------
    def submit(self, query_id: int, query: Graph,
               parallelism: int = 1) -> QueryResult:
        """Synchronous single-query submit (runs the query to
        completion). Compatibility wrapper over :meth:`submit_async`."""
        return self.submit_async(query, query_id=query_id,
                                 parallelism=parallelism).result()

    def submit_batch(self, queries: list[Graph],
                     ids: list[int] | None = None,
                     parallelism: int | list[int] | None = None
                     ) -> list[QueryResult]:
        """Run a batch of queries; on the engine backend all of them
        share the scheduler's waves concurrently (continuous batching:
        as queries finish, queued ones are admitted into their slots).
        Compatibility wrapper: submits handles with bounded-queue
        backpressure, then drains them.

        ``parallelism``: intra-query shard count (shard-as-segments,
        DESIGN.md §3) — an int applied to every query or a per-query
        list. A heavy query submitted with ``parallelism=k`` seeds k
        root segments with work stealing between them, so it fills
        waves instead of idling rows next to light traffic. Ignored by
        the sequential backend (one recursion, nothing to shard).
        """
        from ..core.vectorized import QueueFull
        if ids is None:
            ids = list(range(len(queries)))
        if parallelism is None:
            par = [1] * len(queries)
        elif isinstance(parallelism, int):
            par = [parallelism] * len(queries)
        else:
            par = list(parallelism)
            if len(par) != len(queries):
                raise ValueError(
                    f"parallelism list length {len(par)} != "
                    f"{len(queries)} queries")
        handles: list[MatchHandle] = []
        for eid, q, k in zip(ids, queries, par):
            while True:
                try:
                    handles.append(self.submit_async(
                        q, query_id=eid, parallelism=k))
                    break
                except QueueFull:
                    # bounded-queue backpressure: drain one unit of
                    # work, freeing queue space, then retry — counted,
                    # never silent (surfaced as slo_report's
                    # backpressure_absorbed)
                    self.n_backpressure += 1
                    if not self.step():
                        raise
        return [h.result() for h in handles]

    # ------------------------------------------------------------------
    def slo_report(self) -> dict:
        # instantaneous-load gauges (always present, even before the
        # first completion — the serving tier's /slo endpoint reports
        # live state, not just terminal-state tallies): queue_depth =
        # requests admitted but not yet resident, resident_queries =
        # queries currently occupying engine slots (sequential: the
        # in-flight worker count).
        if self.scheduler is not None:
            gauges = {"queue_depth": len(self.scheduler.queue),
                      "resident_queries": int(self.scheduler.pool.n_active)}
        else:
            self.session._workers = {w for w in self.session._workers
                                     if w.is_alive()}
            gauges = {"queue_depth": len(self.session._pending),
                      "resident_queries": len(self.session._workers)}
        lat = np.asarray(self.latencies)
        if len(lat) == 0:
            return {"n": 0, **gauges,
                    "backpressure_absorbed": int(self.n_backpressure)}
        rep = {"n": len(lat),
               **gauges,
               "p50_ms": float(np.percentile(lat, 50) * 1e3),
               "p99_ms": float(np.percentile(lat, 99) * 1e3),
               "mean_ms": float(lat.mean() * 1e3),
               "timeouts": int(self.n_timeouts),
               "cancelled": int(self.n_cancelled),
               "errors": int(self.n_errors),
               "shed": int(self.n_shed),
               "backpressure_absorbed": int(self.n_backpressure)}
        # time-to-first-embedding percentiles (queries that found >= 1
        # embedding): the streaming SLO — how long until a consumer of
        # MatchHandle.stream() sees its first batch
        ttfe = np.asarray(self.ttfes)
        rep["ttfe_n"] = len(ttfe)
        if len(ttfe):
            rep["ttfe_p50_ms"] = float(np.percentile(ttfe, 50) * 1e3)
            rep["ttfe_p99_ms"] = float(np.percentile(ttfe, 99) * 1e3)
        if self.scheduler is not None:
            rep.update(self.scheduler.scheduler_stats())
        return rep
