"""Versioned JSON wire encoding for the serving tier (DESIGN.md §10).

The port's copy of the reference's protocol: the same ``WIRE_VERSION``,
option whitelist, events and validation, and the same bytes for the same
request or event, so either package's client talks to either server.

Everything that crosses the socket is a JSON object with an explicit
``"v"`` (wire version) — the request envelope, and each NDJSON response
event. The paper's streamed-enumeration semantics (embeddings arrive
incrementally as backtracking progresses, PAPER.md Alg. 2) map onto the
event stream directly:

    {"v": 1, "event": "accepted", "query_id": 7, "tenant": "a"}
    {"v": 1, "event": "chunk", "query_id": 7, "seq": 0, "rows": [[...]]}
    {"v": 1, "event": "chunk", "query_id": 7, "seq": 1, "rows": [[...]]}
    {"v": 1, "event": "done", "query_id": 7, "result": {"status": "ok", ...}}

The union of all ``chunk`` rows equals the blocking API's embedding
set exactly — streaming changes delivery, never the answer. A stream
ends with exactly one terminal event: ``done`` (carrying one of the six
:data:`repro_torch.api.handle.Status` values — ``error`` and ``shed``
included) or ``error`` (the request never became a query: malformed
payload, draining server, unknown tenant action).

Decoding is strict: unknown versions, missing fields, out-of-range
vertex ids and non-whitelisted option knobs all raise
:class:`ProtocolError` — a server must never construct a Graph from a
payload it only half understood.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable

import numpy as np

from ..api.handle import STATUSES
from ..core.graph import Graph

__all__ = [
    "WIRE_VERSION", "ProtocolError", "MatchRequestWire",
    "encode_query", "decode_query", "encode_event", "decode_event",
    "accepted_event", "chunk_event", "done_event", "error_event",
    "REQUEST_OPTION_KEYS",
]

WIRE_VERSION = 1

# per-query knobs a remote caller may set. Engine-level knobs
# (n_slots, wave_size, faults, ...) are the operator's, resolved once at
# server construction — a tenant must not re-shape the shared engine.
REQUEST_OPTION_KEYS = ("limit", "time_budget_s", "max_recursions",
                       "use_pruning", "parallelism", "priority")

_EVENTS = ("accepted", "chunk", "done", "error")


class ProtocolError(ValueError):
    """Malformed or version-incompatible wire payload."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ProtocolError(msg)


def _check_version(obj: dict) -> None:
    _require(isinstance(obj, dict), f"payload must be an object, got "
             f"{type(obj).__name__}")
    v = obj.get("v")
    _require(v == WIRE_VERSION,
             f"unsupported wire version {v!r} (speak v{WIRE_VERSION})")


# ----------------------------------------------------------------------
# query graphs
# ----------------------------------------------------------------------
def encode_query(g: Graph) -> dict:
    """JSON-safe query-graph payload: vertex labels + undirected edge
    list (each edge once, ``a < b``)."""
    src = np.repeat(np.arange(g.n), g.degrees)
    dst = np.asarray(g.indices)
    keep = src < dst                    # CSR holds both directions
    return {
        "n": int(g.n),
        "labels": [int(x) for x in g.labels],
        "edges": [[int(a), int(b)] for a, b in
                  zip(src[keep], dst[keep])],
        "n_labels": int(g.n_labels),
    }


def decode_query(d: Any) -> Graph:
    _require(isinstance(d, dict), "query must be an object")
    for k in ("n", "labels", "edges"):
        _require(k in d, f"query missing {k!r}")
    n = d["n"]
    _require(isinstance(n, int) and 1 <= n <= 64,
             f"query n must be an int in [1, 64], got {n!r}")
    labels = d["labels"]
    _require(isinstance(labels, list) and len(labels) == n,
             f"query labels must be a list of length {n}")
    _require(all(isinstance(x, int) and x >= 0 for x in labels),
             "query labels must be non-negative ints")
    edges = d["edges"]
    _require(isinstance(edges, list), "query edges must be a list")
    for e in edges:
        _require(isinstance(e, list) and len(e) == 2
                 and all(isinstance(x, int) for x in e),
                 f"query edge {e!r} must be [int, int]")
        a, b = e
        _require(0 <= a < n and 0 <= b < n and a != b,
                 f"query edge {e!r} out of range for n={n}")
    n_labels = d.get("n_labels")
    if n_labels is not None:
        _require(isinstance(n_labels, int)
                 and n_labels > max(labels, default=-1),
                 f"n_labels {n_labels!r} inconsistent with labels")
    return Graph.from_edges(n, [(a, b) for a, b in edges], labels,
                            n_labels=n_labels)


# ----------------------------------------------------------------------
# request envelope
# ----------------------------------------------------------------------
@dataclasses.dataclass
class MatchRequestWire:
    """One match request as it crosses the wire: the query graph, the
    tenant it bills to, and the whitelisted per-query option overrides.
    ``request_id`` is the caller's correlation id, echoed verbatim on
    every response event."""
    query: Graph
    tenant: str = "default"
    options: dict = dataclasses.field(default_factory=dict)
    request_id: int | str | None = None

    def to_wire(self) -> dict:
        return {"v": WIRE_VERSION, "query": encode_query(self.query),
                "tenant": self.tenant, "options": dict(self.options),
                "request_id": self.request_id}

    @staticmethod
    def from_wire(obj: Any) -> "MatchRequestWire":
        _check_version(obj)
        _require("query" in obj, "request missing 'query'")
        query = decode_query(obj["query"])
        tenant = obj.get("tenant", "default")
        _require(isinstance(tenant, str) and 0 < len(tenant) <= 128,
                 f"tenant must be a short string, got {tenant!r}")
        options = obj.get("options") or {}
        _require(isinstance(options, dict), "options must be an object")
        for k, val in options.items():
            _require(k in REQUEST_OPTION_KEYS,
                     f"option {k!r} not settable over the wire "
                     f"(allowed: {', '.join(REQUEST_OPTION_KEYS)})")
            _require(val is None or isinstance(val, (int, float, bool)),
                     f"option {k}={val!r} must be a JSON scalar")
        rid = obj.get("request_id")
        _require(rid is None or isinstance(rid, (int, str)),
                 f"request_id must be an int or string, got {rid!r}")
        return MatchRequestWire(query=query, tenant=tenant,
                                options=dict(options), request_id=rid)

    def to_json(self) -> bytes:
        return json.dumps(self.to_wire()).encode()

    @staticmethod
    def from_json(raw: bytes | str) -> "MatchRequestWire":
        try:
            obj = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ProtocolError(f"request is not valid JSON: {e}") from e
        return MatchRequestWire.from_wire(obj)


# ----------------------------------------------------------------------
# response events
# ----------------------------------------------------------------------
def accepted_event(query_id, tenant: str,
                   request_id=None) -> dict:
    return {"v": WIRE_VERSION, "event": "accepted",
            "query_id": query_id, "tenant": tenant,
            "request_id": request_id}


def chunk_event(query_id, seq: int, rows: Iterable) -> dict:
    """One streamed embedding batch: ``rows`` is ``[k, n_query]`` ints
    (row ``i`` maps query position ``j`` -> data vertex ``rows[i][j]``,
    in matching order)."""
    return {"v": WIRE_VERSION, "event": "chunk", "query_id": query_id,
            "seq": int(seq),
            "rows": [[int(x) for x in r] for r in rows]}


def done_event(query_id, result: dict) -> dict:
    """Terminal event. ``result`` is a ``QueryResult.to_dict()``-shaped
    summary; its ``status`` must be one of the six terminal statuses —
    ``error`` and ``shed`` ride the same event so no outcome is
    expressible in-process but not on the wire."""
    st = result.get("status")
    if st not in STATUSES:
        raise ProtocolError(f"done event with non-terminal status {st!r}")
    return {"v": WIRE_VERSION, "event": "done", "query_id": query_id,
            "result": result}


def error_event(message: str, code: str = "bad-request",
                query_id=None) -> dict:
    """The request failed before becoming a query (malformed payload,
    draining server). Queries that *ran* and failed terminate with a
    ``done`` event carrying ``status="error"`` instead."""
    return {"v": WIRE_VERSION, "event": "error", "query_id": query_id,
            "code": str(code), "message": str(message)}


def encode_event(ev: dict) -> bytes:
    """One NDJSON line (the chunked-stream unit)."""
    return (json.dumps(ev, separators=(",", ":")) + "\n").encode()


def decode_event(line: bytes | str) -> dict:
    """Strict inverse of :func:`encode_event` — shape-checks every
    event kind so a client never consumes a half-valid stream."""
    try:
        ev = json.loads(line)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"event is not valid JSON: {e}") from e
    _check_version(ev)
    kind = ev.get("event")
    _require(kind in _EVENTS, f"unknown event kind {kind!r}")
    if kind == "chunk":
        rows = ev.get("rows")
        _require(isinstance(rows, list) and all(
            isinstance(r, list) and all(isinstance(x, int) for x in r)
            for r in rows), "chunk rows must be a list of int lists")
        _require(isinstance(ev.get("seq"), int) and ev["seq"] >= 0,
                 "chunk seq must be a non-negative int")
    elif kind == "done":
        res = ev.get("result")
        _require(isinstance(res, dict), "done event missing result")
        _require(res.get("status") in STATUSES,
                 f"done status {res.get('status')!r} not terminal")
    elif kind == "error":
        _require(isinstance(ev.get("message"), str),
                 "error event missing message")
        _require(isinstance(ev.get("code"), str),
                 "error event missing code")
    return ev
