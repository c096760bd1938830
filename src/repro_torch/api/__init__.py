"""Public request/handle API for subgraph matching (DESIGN.md §4).

    from repro_torch.api import MatchOptions, MatchSession

    session = MatchSession(data_graph, n_slots=16)
    handle = session.submit(query, limit=None)       # non-blocking
    for batch in handle.stream():                    # [k, n_query] int32
        ...                                          # before completion
    result = handle.result()                         # QueryResult
    handle.cancel()                                  # typed eviction

``MatchOptions`` is the single source of truth for every per-query and
per-engine knob; ``QueueFull`` is the typed backpressure signal from
the bounded admission queue.

Submodule note: ``options``/``handle`` are leaf modules imported
eagerly; ``MatchSession`` and ``QueueFull`` resolve lazily because the
core scheduler itself consumes ``api.options`` (PEP 562 keeps the
package importable from either direction).
"""
from .handle import (MatchError, MatchHandle, MatchTimeout, QueryResult,
                     Status, status_of)
from .options import MatchOptions, MatchRequest

__all__ = [
    "MatchError", "MatchHandle", "MatchOptions", "MatchRequest",
    "MatchSession", "MatchTimeout", "QueryResult", "QueueFull",
    "Status", "status_of",
]

_LAZY = {
    "MatchSession": ("repro_torch.api.session", "MatchSession"),
    "QueueFull": ("repro_torch.core.vectorized", "QueueFull"),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    return getattr(importlib.import_module(mod_name), attr)
