"""Stdlib HTTP client for the serving tier (DESIGN.md §10) — used by
the tests and ``chip_smoke.py``. It speaks the reference's wire protocol,
so it talks to either package's server.

Blocking and streaming flavors over the NDJSON wire protocol
(:mod:`repro_torch.server.protocol`):

    client = ServeClient(host, port)
    rows, result = client.match(query, tenant="alpha")   # blocking
    for ev in client.stream(query):                      # streaming
        if ev["event"] == "chunk":
            ...ev["rows"]...

``stream`` decodes strictly (every malformed line raises
:class:`~repro_torch.server.protocol.ProtocolError`) and yields events until
the terminal ``done``/``error`` event inclusive. The embedding union
across ``chunk`` events equals the in-process blocking API's embedding
set exactly — streamed delivery never changes the answer.
"""
from __future__ import annotations

import http.client
import json
import socket
from typing import Iterator

import numpy as np

from ..core.graph import Graph
from .protocol import (MatchRequestWire, ProtocolError, decode_event)

__all__ = ["ServeClient", "ServerError"]


class ServerError(RuntimeError):
    """The server answered with a terminal ``error`` event (or a
    non-200 HTTP status). Carries the wire ``code``."""

    def __init__(self, message: str, code: str = "error"):
        super().__init__(message)
        self.code = code


class ServeClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8421,
                 timeout: float = 300.0):
        self.host = host
        self.port = port
        self.timeout = timeout

    # ------------------------------------------------------------------
    def _conn(self) -> http.client.HTTPConnection:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        conn.connect()
        # request bodies and NDJSON reads are small; Nagle against
        # delayed ACKs costs tens of ms per round trip
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def _get_json(self, path: str) -> dict:
        conn = self._conn()
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise ServerError(
                    f"GET {path} -> {resp.status}: {body[:200]!r}",
                    code=str(resp.status))
            return json.loads(body)
        finally:
            conn.close()

    def health(self) -> dict:
        return self._get_json("/healthz")

    def slo(self) -> dict:
        return self._get_json("/slo")

    def metrics(self) -> dict:
        return self._get_json("/metrics")

    # ------------------------------------------------------------------
    def stream(self, query: Graph, *, tenant: str = "default",
               options: dict | None = None,
               request_id: int | str | None = None) -> Iterator[dict]:
        """Send one match request; yield decoded wire events through
        the terminal event. Closing the generator mid-stream closes the
        connection — the server cancels the query via the eviction
        path."""
        wire = MatchRequestWire(query=query, tenant=tenant,
                                options=dict(options or {}),
                                request_id=request_id)
        body = wire.to_json()
        conn = self._conn()
        try:
            conn.request("POST", "/v1/match", body=body, headers={
                "Content-Type": "application/json",
                "Content-Length": str(len(body))})
            resp = conn.getresponse()
            if resp.status not in (200, 400, 503):
                raise ServerError(
                    f"POST /v1/match -> {resp.status}",
                    code=str(resp.status))
            while True:
                line = resp.readline()
                if not line:
                    raise ProtocolError(
                        "stream ended without a terminal event")
                if not line.strip():
                    continue
                ev = decode_event(line)
                yield ev
                if ev["event"] in ("done", "error"):
                    return
        finally:
            conn.close()

    def match(self, query: Graph, *, tenant: str = "default",
              options: dict | None = None,
              request_id: int | str | None = None
              ) -> tuple[list[np.ndarray], dict]:
        """Blocking convenience: consume the stream, return
        ``(rows, result)`` where ``rows`` is the streamed embedding
        union in arrival order ([n_query]-int32 arrays) and ``result``
        the terminal summary (any of the six statuses). Raises
        :class:`ServerError` on a terminal ``error`` event."""
        rows: list[np.ndarray] = []
        for ev in self.stream(query, tenant=tenant, options=options,
                              request_id=request_id):
            if ev["event"] == "chunk":
                rows.extend(np.asarray(r, np.int32) for r in ev["rows"])
            elif ev["event"] == "done":
                return rows, ev["result"]
            elif ev["event"] == "error":
                raise ServerError(ev["message"], code=ev["code"])
        raise ProtocolError("stream ended without a terminal event")
