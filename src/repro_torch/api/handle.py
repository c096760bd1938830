"""Futures for subgraph-matching queries: :class:`MatchHandle` and the
serving-level :class:`QueryResult` (DESIGN.md §4).

``submit()`` on a session/server returns a handle immediately; the
query runs when the session's scheduler steps. Because the engine is
host-driven (no background thread), the handle is *cooperative*:
``result()`` and ``stream()`` pump the owning session until this query
retires — other concurrent queries make progress on the same waves, so
consuming one handle never starves its neighbors.

Status taxonomy (one definition for every backend):

    "ok"        enumeration ran to completion
    "limit"     stopped at the per-query result cap
    "timeout"   recursion or wall-clock budget exhausted
    "cancelled" evicted by MatchHandle.cancel()
    "error"     quarantined past the failure budget (DESIGN.md §8);
                the typed failure is on ``MatchHandle.error``
    "shed"      dropped by the shed_lowest overload policy
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterator, Literal

import numpy as np

from .options import MatchRequest

__all__ = ["QueryResult", "MatchHandle", "Status", "status_of",
           "MatchError", "MatchTimeout"]

Status = Literal["ok", "limit", "timeout", "cancelled", "error", "shed"]
STATUSES: tuple[str, ...] = ("ok", "limit", "timeout", "cancelled",
                             "error", "shed")


class MatchError(RuntimeError):
    """A query was quarantined past its failure budget (or with
    fallback disabled): runtime fault, not a budget stop. Attached to
    ``MatchHandle.error`` when ``status == "error"``."""


class MatchTimeout(TimeoutError):
    """``MatchHandle.result(timeout=...)`` deadline expired before the
    query completed (the query keeps running; call ``result`` again)."""


def status_of(stats, limit: int | None) -> Status:
    """Map ``SearchStats`` abort bookkeeping to the serving status
    taxonomy (shared by the sequential oracle and the wave engine)."""
    if not stats.aborted:
        return "ok"
    reason = stats.abort_reason
    if reason in ("cancelled", "error", "shed"):
        return reason
    if reason == "limit" or (reason is None and limit is not None
                             and stats.found >= limit):
        return "limit"
    return "timeout"


@dataclasses.dataclass
class QueryResult:
    query_id: int
    n_found: int
    embeddings: list
    latency_s: float
    recursions: int
    timed_out: bool              # True iff status == "timeout"
    aborted: bool = False        # any early stop (limit/budget/cancel)
    status: Status = "ok"
    # full engine stats (EngineStats on the engine backend — includes
    # per-shard rows/items/steal counters for parallelism > 1, and
    # ttfe_s = time to first embedding)
    stats: object = None

    @property
    def ttfe_s(self) -> float | None:
        """Time from submission to the first emitted embedding (None if
        the query found nothing)."""
        return getattr(self.stats, "ttfe_s", None)

    def to_dict(self, include_embeddings: bool = False) -> dict:
        """JSON-safe summary payload: typed ``status``, builtin scalars
        only (no numpy types survive). ``include_embeddings`` adds the
        full embedding rows as lists of ints."""
        ttfe = self.ttfe_s
        d = {
            "query_id": int(self.query_id),
            "status": str(self.status),
            "n_found": int(self.n_found),
            "recursions": int(self.recursions),
            "latency_ms": float(self.latency_s) * 1e3,
            "ttfe_ms": None if ttfe is None else float(ttfe) * 1e3,
            "timed_out": bool(self.timed_out),
            "aborted": bool(self.aborted),
        }
        if include_embeddings:
            d["embeddings"] = [[int(v) for v in np.asarray(e).tolist()]
                               for e in self.embeddings]
        return d


class MatchHandle:
    """Future-like view of one submitted query.

    * :meth:`done` — non-blocking completion check;
    * :meth:`result` — pump the session until this query retires,
      return its :class:`QueryResult`;
    * :meth:`stream` — iterator yielding ``[k, n_query]`` int32
      embedding batches *as waves emit them* (before completion);
    * :meth:`cancel` — evict the query via the scheduler's existing
      eviction path; neighbors sharing its waves are untouched.
    """

    def __init__(self, session, request: MatchRequest):
        self._session = session
        self.request = request
        self.query_id: int | None = request.request_id  # set at submit
        # undelivered in-flight batches; cleared at completion (late /
        # repeat consumers replay from result().embeddings instead, so
        # blocking callers never hold a duplicate copy of their rows)
        self._batches: collections.deque[np.ndarray] = collections.deque()
        self._result: QueryResult | None = None
        self._cancel_requested = False
        self._worker = None        # sequential stream() worker thread
        # typed failure attached by the session when status == "error"
        self.error: MatchError | None = None

    # ------------------------------------------------------------------
    def done(self) -> bool:
        return self._result is not None

    @property
    def status(self) -> Status | Literal["pending"]:
        return self._result.status if self._result is not None \
            else "pending"

    def result(self, timeout: float | None = None) -> QueryResult:
        """Drive the session until this query completes (returns
        immediately when it already has).

        ``timeout`` bounds the wall-clock time spent pumping; past the
        deadline :class:`MatchTimeout` is raised instead of blocking on
        a stalled scheduler. The query itself keeps its state — calling
        ``result`` again resumes pumping."""
        if timeout is None:
            while self._result is None:
                self._session._pump(self)
            return self._result
        deadline = time.perf_counter() + timeout
        while self._result is None:
            if time.perf_counter() >= deadline:
                raise MatchTimeout(
                    f"query {self.query_id} did not complete within "
                    f"{timeout:g}s")
            self._session._pump(self)
        return self._result

    def stream(self) -> Iterator[np.ndarray]:
        """Yield embedding batches incrementally. The union of all
        yielded rows equals ``result().embeddings`` exactly — streaming
        changes delivery, never the answer. Safe to call after
        completion, and safe to call again: a finished handle replays
        its full embedding set from the result (one iterator at a
        time; concurrent iterators over one handle are not supported)."""
        return self._session._stream(self)

    def cancel(self) -> bool:
        """Request cancellation. Returns True if the query was still
        pending/running (its status becomes ``"cancelled"``; embeddings
        already emitted are kept), False if it had already finished."""
        if self._result is not None:
            return False
        self._cancel_requested = True
        return self._session._cancel(self)

    # ---- session-side plumbing ---------------------------------------
    def _push(self, batch: np.ndarray) -> None:
        """Embedding-delivery sink (called by the scheduler mid-wave)."""
        self._batches.append(np.asarray(batch, np.int32))

    def _complete(self, result: QueryResult) -> None:
        self._result = result
        # drop the in-flight buffer: an active stream iterator resumes
        # from result.embeddings at its yielded-row cursor, and late
        # consumers replay from there too — no duplicate copy survives
        self._batches.clear()

    def __repr__(self) -> str:            # pragma: no cover
        return (f"MatchHandle(query_id={self.query_id}, "
                f"status={self.status!r})")
