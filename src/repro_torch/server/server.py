"""The serving-tier HTTP request loop of the port (DESIGN.md §10).

Process layout — one :class:`MatchServer` owns three kinds of thread:

* the **engine thread** is the only thread that ever touches the
  :class:`~repro_torch.serving.query_server.QueryServer` / scheduler (the
  wave loop is host-driven, single-threaded state; its device tensors
  are built on the constructing thread and every launch goes to the
  default stream). It admits requests
  from the :class:`~repro_torch.server.admission.AdmissionController` in WFQ
  order, absorbs ``QueueFull`` backpressure (requeue-at-head + counter,
  never a drop), steps the session, and forwards each query's freshly
  emitted embedding batches to its response queue — the wire stream is
  fed by the same incremental delivery that feeds
  ``MatchHandle.stream()`` in-process;
* **HTTP handler threads** (stdlib ``ThreadingHTTPServer``) decode one
  request each, then block on the request's event queue, writing each
  event as one NDJSON line and flushing — chunked streaming with zero
  buffering between the engine and the socket. A write failure
  (client went away mid-stream) cancels the query through the
  scheduler's existing eviction path; co-resident queries are
  untouched;
* the **drain waiter** (SIGTERM): stop admitting new wire requests
  (typed ``draining`` error event + HTTP 503), let queued + resident
  queries finish (bounded by ``drain_timeout_s``, then cancelled
  through the eviction path), flush the final SLO report, stop the
  listener.

An exception out of the session's step (a device fault: the scheduler
itself retries only injected faults and OOM) stops the server: every
resident and queued request ends with a ``status="error"`` done event
carrying it, and new requests get a typed ``engine-failed`` event.

Endpoints:

    POST /v1/match            NDJSON event stream (protocol.py)
    POST /v1/match?stream=0   single JSON {"events": [...]} (blocking)
    GET  /slo                 engine SLO report (+ live gauges)
    GET  /metrics             wire + admission + engine counters
    GET  /healthz             {"ok": true, "draining": ..., "graph": ...}
"""
from __future__ import annotations

import json
import queue as _queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..api.handle import MatchHandle
from ..core.vectorized import QueueFull
from ..serving.query_server import QueryServer
from .admission import AdmissionController
from .metrics import ServerMetrics
from . import protocol
from .protocol import ProtocolError
from .server_args import ServerArgs

__all__ = ["MatchServer"]


def _jsonify(obj):
    """Recursively convert numpy scalars/arrays so every metrics
    payload survives ``json.dumps``."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


class _ServeRequest:
    """One wire request's server-side state. The event queue is the
    engine-thread -> handler-thread seam; everything else is touched by
    one thread at a time (handle only by the engine thread)."""

    __slots__ = ("wire", "query_id", "priority", "events", "handle",
                 "n_sent", "seq", "cancel_requested", "t_accept",
                 "options")

    def __init__(self, wire: protocol.MatchRequestWire, query_id: int):
        self.wire = wire
        self.query_id = query_id
        self.priority = int(wire.options.get("priority") or 0)
        self.events: _queue.Queue = _queue.Queue()
        self.handle: MatchHandle | None = None
        self.n_sent = 0            # embedding rows already streamed
        self.seq = 0               # chunk sequence number
        self.cancel_requested = False
        self.t_accept = time.perf_counter()
        self.options: dict = dict(wire.options)

    # terminal results for requests that never reached the engine ------
    def _terminal(self, status: str, **extra) -> dict:
        res = {"query_id": self.query_id, "status": status, "n_found": 0,
               "recursions": 0,
               "latency_ms": (time.perf_counter() - self.t_accept) * 1e3,
               "ttfe_ms": None, "timed_out": status == "timeout",
               "aborted": True, "request_id": self.wire.request_id}
        res.update(extra)
        return res

    def push_done(self, result: dict) -> None:
        self.events.put(protocol.done_event(self.query_id, result))


class MatchServer:
    """The serving tier: engine thread + admission + HTTP listener over
    one data graph. Construct, then :meth:`serve_forever` (blocking) or
    :meth:`start`/:meth:`shutdown` (tests)."""

    def __init__(self, data, args: ServerArgs | None = None,
                 log=None):
        self.args = args = args or ServerArgs()
        self.data = data
        self.log = log or (lambda *a, **k: None)
        self.options = args.build_options()
        self.qserver = QueryServer(data, backend=args.backend,
                                   options=self.options, device=args.device)
        self.metrics = ServerMetrics()
        tenants, default = args.build_tenants()
        self.admission = AdmissionController(
            tenants, default, on_shed=self._on_admission_shed)
        self._live: dict[int, _ServeRequest] = {}
        self.baseline_qps: float | None = None   # set by warmup()
        self.failure: Exception | None = None    # set by _fail()
        # generator recipe for the resident graph: build_graph is
        # deterministic in these, so a remote client can reconstruct
        # the identical graph and generate valid queries against it
        # (examples/serve_queries.py --server does)
        self.graph_info = {
            "kind": args.graph, "n": args.graph_n, "m": args.graph_m,
            "labels": args.graph_labels,
            "extra_edges": args.graph_extra_edges,
            "seed": args.graph_seed, "n_vertices": int(data.n),
            "n_edges": int(data.n_edges),
            "n_labels": int(data.n_labels)}
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._work = threading.Event()     # engine wake signal
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._engine_thread: threading.Thread | None = None
        self._t_report = 0.0
        srv = self

        class _BoundHandler(_Handler):
            server_ref = srv

        class _Listener(ThreadingHTTPServer):
            daemon_threads = True
            # the stdlib default listen backlog (5) drops SYNs under a
            # connection burst — the kernel's 1s retransmit then shows
            # up as a spurious p99 latency cliff
            request_queue_size = 128
            # NDJSON streaming writes one small line per event; Nagle
            # batching against delayed ACKs turns that into tens of ms
            # of added TTFE per request
            disable_nagle_algorithm = True

        self.httpd = _Listener((args.host, args.port), _BoundHandler)
        self.host, self.port = self.httpd.server_address[:2]

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Prepare the engine before taking traffic. On the card the
        refine kernels' libraries are built first (``nvcc``, once per
        source: seconds a tenant would otherwise pay on its first
        wave). Then, through the *serving* engine instance, one full
        batch and a descending ladder of batch sizes run every
        admission-burst size once (the reference's ladder, which there
        compiles each power-of-two burst variant; here it warms the
        caching allocator and the kernels' first launches), and two more
        full batches give the in-process ``baseline_qps``. The warmup
        queries' latencies are scrubbed from the SLO tallies
        afterwards."""
        if self.qserver.session.device.type == "cuda":
            from ..kernels import build
            build.build_all(["refine_bitmap_rows",
                             "refine_bitmap_rows_hier"])
        if self.args.warmup_queries <= 0:
            return
        from ..data.graph_gen import query_set
        qs = query_set(self.data, self.args.warmup_query_size,
                       max(self.args.warmup_queries, 1), seed=1)
        t0 = time.perf_counter()
        sch = self.qserver.scheduler
        if sch is None:
            self.qserver.submit_batch(qs)
        else:
            # [n, n, n/2, ..., 2, 1]: every admission-burst size once
            sizes = [sch.n_slots, sch.n_slots]
            k = sch.n_slots // 2
            while k >= 1:
                sizes.append(k)
                k //= 2
            for size in sizes:
                self.qserver.submit_batch(
                    [qs[i % len(qs)] for i in range(size)])
            # in-process baseline on the *serving* engine (best of 2
            # warm full batches): the denominator for the serving
            # tier's wire-overhead ratio — same process, same engine,
            # same query shapes as a wire burst
            for _ in range(2):
                batch = [qs[i % len(qs)] for i in range(sch.n_slots)]
                tb = time.perf_counter()
                self.qserver.submit_batch(batch)
                qps = len(batch) / (time.perf_counter() - tb)
                self.baseline_qps = max(self.baseline_qps or 0.0, qps)
        # warmup traffic must not pollute the serving SLO percentiles
        q = self.qserver
        q.latencies.clear()
        q.ttfes.clear()
        q.n_timeouts = q.n_cancelled = q.n_errors = 0
        q.n_shed = q.n_backpressure = 0
        self.log(f"warmup: admission burst ladder served "
                 f"({time.perf_counter() - t0:.1f}s); "
                 f"in-process baseline "
                 f"{self.baseline_qps or float('nan'):.1f} qps")

    def start(self) -> None:
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="repro-engine", daemon=True)
        self._engine_thread.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="repro-http",
            daemon=True)
        self._http_thread.start()

    def serve_forever(self) -> None:
        """Blocking run: returns after a drain completes or the engine
        fails (``self.failure``)."""
        self.start()
        # wake now and then: a signal that lands on another thread is
        # handled only once the main thread runs Python code again
        while not self._drained.wait(timeout=0.2):
            pass
        self.httpd.shutdown()
        self._http_thread.join(timeout=10)

    def begin_drain(self) -> None:
        """Graceful shutdown: stop admitting new wire requests, finish
        queued + resident queries (bounded by ``drain_timeout_s``),
        then release :meth:`serve_forever`."""
        self.metrics.draining = True
        self._draining.set()
        self._work.set()

    def shutdown(self, drain: bool = True) -> None:
        """Test/embedding teardown: optionally drain, then stop the
        listener and join the engine thread."""
        if drain:
            self.begin_drain()
            self._drained.wait(timeout=self.args.drain_timeout_s + 30)
        else:
            self._draining.set()
            self._drained.set()
            self._work.set()
        self.httpd.shutdown()
        if self._engine_thread is not None:
            self._engine_thread.join(timeout=10)

    # ------------------------------------------------------------------
    # handler-thread side
    # ------------------------------------------------------------------
    def submit_wire(self, wire: protocol.MatchRequestWire
                    ) -> _ServeRequest | dict:
        """Validate + admit one decoded request (handler thread).
        Returns the live :class:`_ServeRequest`, or a terminal error
        event dict when the request never became a query."""
        self.metrics.bump("requests_total")
        if self.failure is not None:
            return protocol.error_event(
                f"engine failed: {self.failure!r}", code="engine-failed")
        if self._draining.is_set():
            self.metrics.bump("draining_rejects")
            return protocol.error_event(
                "server is draining; retry against another replica",
                code="draining")
        try:    # validate option values with the engine defaults folded
            self.options.replace(**{
                k: v for k, v in wire.options.items()
                if k in protocol.REQUEST_OPTION_KEYS})
        except (ValueError, TypeError) as e:
            self.metrics.bump("protocol_errors")
            return protocol.error_event(f"invalid options: {e}",
                                        code="bad-options")
        with self._id_lock:
            qid = self._next_id
            self._next_id += 1
        req = _ServeRequest(wire, qid)
        self.metrics.bump("accepted")
        self.admission.offer(req, wire.tenant)
        self._work.set()
        return req

    def _on_admission_shed(self, req: _ServeRequest) -> None:
        """Bounded-queue drop: terminal ``status="shed"`` over the wire
        (the same taxonomy as the engine's shed_lowest policy)."""
        self.metrics.bump("admission_shed")
        req.push_done(req._terminal("shed", shed_by="admission"))

    def request_cancel(self, req: _ServeRequest,
                       disconnect: bool = False) -> None:
        """Handler thread: client disconnected (or asked to stop) —
        ride the scheduler's eviction path at the engine thread's next
        deliver pass."""
        req.cancel_requested = True
        if disconnect:
            self.metrics.bump("client_disconnects")
        self._work.set()

    # ------------------------------------------------------------------
    # engine thread
    # ------------------------------------------------------------------
    def _engine_loop(self) -> None:
        session = self.qserver.session
        t_drain_start = None
        while True:
            did = self._admit_ready()
            if not session.idle:
                try:
                    did = session.step() or did
                except Exception as e:
                    # a device fault (the scheduler retries only
                    # injected faults and OOM) ends the process: every
                    # request learns it at once, not at a stall timeout
                    self._fail(e)
                    return
            did = self._deliver() or did
            now = time.perf_counter()
            if now - self._t_report >= self.args.metrics_refresh_s:
                self._refresh_report()
            if self._draining.is_set():
                if t_drain_start is None:
                    t_drain_start = now
                busy = (self.admission.depth or self._live
                        or not session.idle)
                if busy and (now - t_drain_start
                             > self.args.drain_timeout_s):
                    self._force_cancel_all()
                    busy = False
                if not busy:
                    self._refresh_report()
                    self._drained.set()
                    return
            if not did:
                self._work.wait(timeout=self.args.idle_poll_s)
                self._work.clear()

    def _admit_ready(self) -> bool:
        """Pull WFQ-ordered admissible requests into the engine until it
        pushes back. ``QueueFull`` is absorbed (requeue at head +
        counter), never surfaced to the tenant — the admission queue is
        the retry buffer."""
        did = False
        while True:
            req = self.admission.next_ready()
            if req is None:
                return did
            if req.cancel_requested:   # died waiting in the queue
                req.push_done(req._terminal("cancelled"))
                self.admission.note_completed(req.wire.tenant)
                self.metrics.bump("completed")
                continue
            try:
                opts = {k: v for k, v in req.options.items()
                        if k in protocol.REQUEST_OPTION_KEYS}
                req.handle = self.qserver.submit_async(
                    req.wire.query, query_id=req.query_id, **opts)
            except QueueFull:
                self.admission.requeue_front(req, req.wire.tenant)
                self.metrics.bump("backpressure_absorbed")
                return did
            except Exception as e:     # unexpected submit failure:
                # terminal error status — never leave a handler thread
                # blocked on an event queue nobody will feed
                req.push_done(req._terminal(
                    "error", timed_out=False, error=f"{e!r}"))
                self.admission.note_completed(req.wire.tenant)
                self.metrics.bump("completed")
                continue
            self.metrics.bump("submitted")
            req.events.put(protocol.accepted_event(
                req.query_id, req.wire.tenant, req.wire.request_id))
            self._live[req.query_id] = req
            did = True

    def _deliver(self) -> bool:
        """Forward freshly emitted embedding batches to each live
        request's wire stream; retire completed handles with their
        terminal event. Mirrors ``MatchSession._stream``'s cursor
        logic: on completion any rows not yet streamed are flushed from
        ``result().embeddings[n_sent:]``."""
        did = False
        for qid in list(self._live):
            req = self._live[qid]
            h = req.handle
            if req.cancel_requested and not h.done():
                h.cancel()             # scheduler eviction path
            while h._batches:
                batch = h._batches.popleft()
                req.events.put(protocol.chunk_event(
                    qid, req.seq, np.asarray(batch).tolist()))
                req.seq += 1
                req.n_sent += len(batch)
                self.metrics.bump("chunks_streamed")
                self.metrics.bump("rows_streamed", len(batch))
                did = True
            if h.done():
                res = h._result
                emb = res.embeddings
                if req.n_sent < len(emb):
                    rows = [np.asarray(e).tolist()
                            for e in emb[req.n_sent:]]
                    req.events.put(protocol.chunk_event(
                        qid, req.seq, rows))
                    req.seq += 1
                    req.n_sent += len(rows)
                    self.metrics.bump("chunks_streamed")
                    self.metrics.bump("rows_streamed", len(rows))
                d = res.to_dict()
                d["tenant"] = req.wire.tenant
                d["request_id"] = req.wire.request_id
                if res.status == "error" and h.error is not None:
                    d["error"] = str(h.error)
                req.push_done(d)
                del self._live[qid]
                self.admission.note_completed(req.wire.tenant)
                self.metrics.bump("completed")
                did = True
        return did

    def _fail(self, exc: Exception) -> None:
        """``session.step()`` raised: end every resident and queued
        request with a terminal ``error`` done event carrying the
        exception, refuse new ones, and release :meth:`serve_forever`
        (``launch`` then exits non-zero)."""
        self.failure = exc
        self.log(f"engine step failed: {exc!r}")
        self.metrics.draining = True
        self._draining.set()
        failed = list(self._live.values()) + self.admission.pending_items()
        self._live.clear()
        for req in failed:
            req.push_done(req._terminal("error", timed_out=False,
                                        error=f"{exc!r}"))
            self.admission.note_completed(req.wire.tenant)
            self.metrics.bump("completed")
        # let the handler threads pick their events up before the
        # listener stops (bounded)
        deadline = time.monotonic() + 5.0
        while (any(not r.events.empty() for r in failed)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        self._drained.set()

    def _force_cancel_all(self) -> None:
        """Drain deadline expired: evict every resident query and shed
        everything still queued (all reach a terminal status)."""
        self.log("drain timeout: cancelling resident queries")
        for req in self.admission.pending_items():
            req.cancel_requested = True
        self._admit_ready()            # flush queue -> cancelled events
        for req in self._live.values():
            if req.handle is not None and not req.handle.done():
                req.handle.cancel()
        self._deliver()

    def _refresh_report(self) -> None:
        """Engine-thread-only: snapshot the SLO report for /slo and
        /metrics (``scheduler_stats`` mutates scheduler state, so HTTP
        threads must never call it live)."""
        self.metrics.set_engine_report(_jsonify(self.qserver.slo_report()))
        self._t_report = time.perf_counter()


# ----------------------------------------------------------------------
# HTTP layer
# ----------------------------------------------------------------------
class _Handler(BaseHTTPRequestHandler):
    server_ref: MatchServer = None      # bound per-server subclass
    server_version = "repro-serve/1"
    protocol_version = "HTTP/1.0"       # Connection: close; EOF-delimited

    def log_message(self, fmt, *args):  # quiet by default
        self.server_ref.log(f"http: {fmt % args}")

    # ------------------------------------------------------------------
    def _send_json(self, payload: dict, code: int = 200) -> None:
        body = json.dumps(_jsonify(payload), indent=2).encode() + b"\n"
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        srv = self.server_ref
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            self._send_json({"ok": True,
                             "draining": srv.metrics.draining,
                             "graph": srv.graph_info})
        elif path == "/slo":
            self._send_json(srv.metrics.slo())
        elif path == "/metrics":
            self._send_json(srv.metrics.snapshot(srv.admission))
        else:
            self._send_json({"error": f"unknown path {path!r}"}, 404)

    # ------------------------------------------------------------------
    def do_POST(self) -> None:
        srv = self.server_ref
        path, _, query_str = self.path.partition("?")
        if path != "/v1/match":
            self._send_json({"error": f"unknown path {path!r}"}, 404)
            return
        stream = "stream=0" not in query_str
        try:
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length)
            wire = protocol.MatchRequestWire.from_json(raw)
        except ProtocolError as e:
            srv.metrics.bump("protocol_errors")
            self._send_events([protocol.error_event(str(e))], code=400)
            return
        out = srv.submit_wire(wire)
        if isinstance(out, dict):       # terminal error pre-admission
            code = (503 if out.get("code") in ("draining", "engine-failed")
                    else 400)
            self._send_events([out], code=code)
            return
        if stream:
            self._stream_events(out)
        else:
            self._blocking_events(out)

    # ------------------------------------------------------------------
    def _send_events(self, events: list, code: int = 200) -> None:
        body = b"".join(protocol.encode_event(e) for e in events)
        self.send_response(code)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _stream_events(self, req: _ServeRequest) -> None:
        """NDJSON streaming: one event per line, flushed as the engine
        emits it. A failed write = the client went away -> cancel the
        query via the eviction path and stop consuming."""
        srv = self.server_ref
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            self.wfile.flush()
            while True:
                try:
                    ev = req.events.get(
                        timeout=srv.args.drain_timeout_s + 300.0)
                except _queue.Empty:
                    self.wfile.write(protocol.encode_event(
                        protocol.error_event(
                            "server stalled delivering events",
                            code="stalled", query_id=req.query_id)))
                    return
                self.wfile.write(protocol.encode_event(ev))
                self.wfile.flush()
                if ev["event"] in ("done", "error"):
                    return
        except (BrokenPipeError, ConnectionResetError, OSError):
            srv.request_cancel(req, disconnect=True)

    def _blocking_events(self, req: _ServeRequest) -> None:
        """?stream=0 — collect the whole event stream, answer once."""
        srv = self.server_ref
        events = []
        while True:
            try:
                ev = req.events.get(
                    timeout=srv.args.drain_timeout_s + 300.0)
            except _queue.Empty:
                events.append(protocol.error_event(
                    "server stalled delivering events", code="stalled",
                    query_id=req.query_id))
                break
            events.append(ev)
            if ev["event"] in ("done", "error"):
                break
        try:
            self._send_events(events)
        except (BrokenPipeError, ConnectionResetError, OSError):
            srv.metrics.bump("client_disconnects")
