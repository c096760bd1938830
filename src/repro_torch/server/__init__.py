"""Network serving tier of the port (DESIGN.md §10): a standalone server
process in front of the port's in-process engine, speaking the
reference's wire protocol at the same ``WIRE_VERSION``, so either
package's client talks to either package's server.

* :mod:`repro_torch.server.server_args` — CLI-parseable :class:`ServerArgs`
  (host/port, data-graph spec, the engine's device, engine knobs
  resolved through ``MatchOptions``/the tuning cache, tenant admission
  config);
* :mod:`repro_torch.server.protocol` — the versioned JSON wire encoding
  (query graphs, per-query options, streamed embedding chunks, terminal
  results carrying every ``Status``, typed errors);
* :mod:`repro_torch.server.server` — the HTTP request loop over
  ``MatchSession``: one engine thread owns the scheduler, handler
  threads stream NDJSON events, client disconnects ride the eviction
  path, SIGTERM drains gracefully;
* :mod:`repro_torch.server.admission` — multi-tenant admission: per-tenant
  token buckets, weighted fair queueing, bounded-queue load shedding;
* :mod:`repro_torch.server.metrics` — the ``/metrics`` + ``/slo``
  exporter (with the refine kernels' launch counts);
* :mod:`repro_torch.server.client` — the stdlib blocking/streaming client
  used by tests and ``chip_smoke.py``.

Launch:  ``python -m repro_torch.server.launch --graph ba --port 8421``
(on the card; ``--device cpu`` runs the plain versions on the host)
"""
from .admission import AdmissionController, TenantConfig
from .client import ServeClient
from .protocol import (ProtocolError, WIRE_VERSION, decode_event,
                       decode_query, encode_event, encode_query)
from .server import MatchServer
from .server_args import ServerArgs

__all__ = [
    "AdmissionController", "TenantConfig", "ServeClient",
    "ProtocolError", "WIRE_VERSION", "decode_event", "decode_query",
    "encode_event", "encode_query", "MatchServer", "ServerArgs",
]
