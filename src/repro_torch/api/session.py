"""The request/handle front door over the matching engines
(DESIGN.md §4).

A :class:`MatchSession` owns one backend — the shared-wave scheduler
(``backend="engine"``) or the paper's sequential Algorithm 2 reference
(``backend="sequential"``) — and turns submissions into
:class:`~repro_torch.api.handle.MatchHandle` futures:

* ``submit()`` is **non-blocking**: it enqueues through the bounded
  admission queue (raising :class:`QueueFull` for backpressure) and
  returns a handle immediately;
* progress is **cooperative**: the host thread advances the engine by
  calling ``session.step()`` / ``session.run()``, or implicitly by
  consuming any handle's ``result()`` / ``stream()`` — all resident
  queries share the same waves, so pumping one handle progresses all;
* embeddings are **streamed**: the scheduler delivers each query's
  newly found batches to its handle as the emitting wave's digest is
  processed, so ``stream()`` yields results long before retirement
  (TTFE ≪ completion on enumeration-heavy queries);
* ``cancel()`` rides the scheduler's existing eviction path — a
  cancelled query's neighbors are untouched.

The sequential backend serves the same lifecycle one query at a time
(FIFO): ``stream()`` runs the search on a worker thread and yields each
embedding as the recursion reports it, and ``cancel()`` aborts at the
next poll point. It remains the correctness oracle for the streamed
API: both backends yield unions identical to their blocking results.
"""
from __future__ import annotations

import collections
import contextlib
import queue as _queue
import threading
import time

import numpy as np

from ..core.backtrack import backtrack_deadend
from ..core.vectorized import QueueFull, WaveScheduler
from ..kernels.config import resolve_device
from .handle import MatchError, MatchHandle, QueryResult, status_of
from .options import MatchOptions, MatchRequest

__all__ = ["MatchSession"]


class MatchSession:
    """Request/handle sessions over one data graph.

    ``options`` (plus keyword overrides) configures the engine *and*
    provides the default per-query options; an existing ``scheduler``
    may be passed to wrap it instead of constructing one. ``device``
    (default ``"cuda"``) is where the engine's banks live; without a
    card the default raises, on either backend — tests pass ``"cpu"``.
    """

    def __init__(self, data, *, options: MatchOptions | None = None,
                 backend: str = "engine",
                 scheduler: WaveScheduler | None = None, device="cuda",
                 **knobs):
        if backend not in ("engine", "sequential"):
            raise ValueError(f"unknown backend: {backend!r}")
        self.device = (scheduler.device if scheduler is not None
                       else resolve_device(device))
        self.data = data
        self.backend = backend
        self.options = (scheduler.options if scheduler is not None
                        else MatchOptions.resolve(options, **knobs))
        self.scheduler = (
            (scheduler if scheduler is not None
             else WaveScheduler(data, options=self.options,
                                device=self.device))
            if backend == "engine" else None)
        # completion hook: called with each finished QueryResult (the
        # serving layer records latency / TTFE / timeout tallies here)
        self.on_complete = None
        self._handles: dict[int, MatchHandle] = {}     # engine: sched qid
        self._pending: collections.deque[MatchHandle] = collections.deque()
        self._workers: set[threading.Thread] = set()   # sequential streams
        self._next_seq = 0

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, query, *, options: MatchOptions | None = None,
               query_id: int | None = None, cand=None, order=None,
               **overrides) -> MatchHandle:
        """Non-blocking submit; returns a :class:`MatchHandle`.

        Raises :class:`QueueFull` when the bounded admission queue is at
        capacity (typed backpressure — callers shed load or drain via
        ``step()``). ``query_id`` sets the caller-visible id on the
        result (defaults to the engine-assigned id). On the engine
        backend the call is the scheduler's ``submit`` span, carrying
        that id.
        """
        sched = self.scheduler
        span = (contextlib.nullcontext() if sched is None else
                sched.spans.span("submit", sched.next_qid
                                 if query_id is None else query_id))
        with span:
            opts = MatchOptions.resolve(
                options if options is not None else self.options,
                **overrides)
            req = MatchRequest(query=query, options=opts,
                               request_id=query_id, cand=cand, order=order)
            h = MatchHandle(self, req)
            h._t_submit = time.perf_counter()
            if self.backend == "engine":
                sched_qid = sched.submit(
                    query, options=opts, cand=cand, order=order,
                    on_embeddings=h._push)
                h._sched_qid = sched_qid
                h.query_id = sched_qid if query_id is None else query_id
                self._handles[sched_qid] = h
                # trivial queries retire inside submit
                with sched.spans.span("retire"):
                    self._drain()
            else:
                if len(self._pending) >= opts.max_queue:
                    raise QueueFull(
                        f"admission queue at capacity ({opts.max_queue})")
                if query_id is None:
                    h.query_id = self._next_seq
                self._next_seq += 1
                self._pending.append(h)
            return h

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """Advance the backend by one unit of work (one scheduler wave /
        one sequential query); returns False when idle."""
        if self.backend == "engine":
            progressed = self.scheduler.step()
            self._drain()
            return progressed
        if not self._pending:
            return False
        self._run_sequential(self._pending.popleft())
        return True

    def run(self) -> None:
        """Drain every queued and in-flight query."""
        while self.step():
            pass

    @property
    def idle(self) -> bool:
        if self.backend == "engine":
            return self.scheduler.idle
        self._workers = {w for w in self._workers if w.is_alive()}
        return not self._pending and not self._workers

    # ------------------------------------------------------------------
    # handle-side plumbing
    # ------------------------------------------------------------------
    def _pump(self, h: MatchHandle) -> None:
        """Advance until *some* progress lands (used by handle.result /
        handle.stream); raises if the backend idles while ``h`` is
        still incomplete (a submit that never reached the queue)."""
        if h.done():
            return
        if h._worker is not None:
            # a sequential stream() moved this handle onto a worker
            # thread: completion comes from there, not from step()
            h._worker.join()
            return
        if not self.step() and not h.done():
            raise RuntimeError(
                f"session idle but handle {h.query_id!r} incomplete")

    def _cancel(self, h: MatchHandle) -> bool:
        if self.backend == "engine":
            ok = self.scheduler.cancel(h._sched_qid)
            if ok:
                self._drain()      # cancellation retires synchronously
            return ok
        if h in self._pending:     # never started: retire as cancelled
            self._pending.remove(h)
            from ..core.backtrack import SearchStats
            stats = SearchStats(aborted=True, abort_reason="cancelled")
            self._finish_handle(h, [], stats, 0.0)
            return True
        # running inside a stream() worker: h._cancel_requested is set;
        # the search aborts at its next poll point
        return not h.done()

    def _stream(self, h: MatchHandle):
        if self.backend == "engine":
            # delivered batches are consecutive slices of the query's
            # embedding list, so a yielded-row cursor is enough to
            # resume from result.embeddings once the handle completes —
            # which also makes a fresh post-completion stream() a full
            # replay (cursor 0) with no duplicate buffer held.
            n = 0
            while not h.done():
                while h._batches:
                    batch = h._batches.popleft()
                    n += len(batch)
                    yield batch
                if h.done():
                    break
                self._pump(h)
            emb = h._result.embeddings
            if n < len(emb):
                yield np.stack([np.asarray(e, np.int32)
                                for e in emb[n:]])
        else:
            yield from self._stream_sequential(h)

    # ------------------------------------------------------------------
    # completion
    # ------------------------------------------------------------------
    def _finish_handle(self, h: MatchHandle, embeddings, stats,
                       latency_s: float) -> None:
        status = status_of(stats, h.request.options.limit)
        if status == "error":
            h.error = MatchError(getattr(stats, "fault", None)
                                 or "query failed")
        qr = QueryResult(
            query_id=h.query_id, n_found=stats.found,
            embeddings=embeddings, latency_s=latency_s,
            recursions=stats.recursions, timed_out=status == "timeout",
            aborted=stats.aborted, status=status, stats=stats)
        h._complete(qr)
        if self.on_complete is not None:
            self.on_complete(qr)

    def _drain(self) -> None:
        """Retire finished scheduler queries into their handles. Only
        session-submitted query ids are popped — results of queries
        submitted directly on the scheduler stay in
        ``scheduler.finished`` for their owner."""
        for qid in self.scheduler.poll():
            h = self._handles.pop(qid, None)
            if h is None:
                continue
            res = self.scheduler.finished.pop(qid, None)
            if res is None:
                continue
            self._finish_handle(h, res.embeddings, res.stats,
                                time.perf_counter() - h._t_submit)

    # ------------------------------------------------------------------
    # sequential backend
    # ------------------------------------------------------------------
    def _run_sequential(self, h: MatchHandle,
                        stream_q: "_queue.Queue | None" = None) -> None:
        opts = h.request.options

        def on_emb(emb: np.ndarray) -> None:
            batch = np.asarray(emb, np.int32)[None, :].copy()
            h._push(batch)
            if stream_q is not None:
                stream_q.put(batch)

        res = backtrack_deadend(
            h.request.query, self.data, cand=h.request.cand,
            order=h.request.order, limit=opts.limit,
            max_recursions=opts.max_recursions,
            time_budget_s=opts.time_budget_s,
            use_pruning=(True if opts.use_pruning is None
                         else opts.use_pruning),
            on_embedding=on_emb,
            should_abort=lambda: h._cancel_requested)
        # latency = execution wall time (queueing is host-side FIFO)
        self._finish_handle(h, res.embeddings, res.stats,
                            res.stats.wall_time_s)
        if stream_q is not None:
            stream_q.put(None)

    def _stream_sequential(self, h: MatchHandle):
        if not h.done():
            # FIFO admission: run every query queued ahead of this one
            while self._pending and self._pending[0] is not h:
                self.step()
        if h.done():               # completed (or cancelled) already —
            emb = h._result.embeddings         # replay from the result
            if emb:
                yield np.stack([np.asarray(e, np.int32) for e in emb])
            return
        self._pending.remove(h)
        sq: _queue.Queue = _queue.Queue()
        worker = threading.Thread(
            target=self._run_sequential, args=(h, sq), daemon=True)
        # registered before start so result()/idle see the in-flight
        # worker even if this generator is abandoned mid-consumption
        h._worker = worker
        self._workers.add(worker)
        worker.start()
        while True:
            batch = sq.get()
            if batch is None:
                break
            yield batch
        worker.join()
