"""Knob resolution for the port: explicit user value > MatchOptions >
tuning-cache record > built-in default.

:func:`resolve_engine_options` is the one funnel: ``WaveScheduler``
calls it at construction (via ``MatchOptions.resolved_engine``) with the
backend its device's kernels take (``kernels.config.device_backend``),
and the returned descriptor is what ``scheduler_stats()["tuning"]``
surfaces — the consumed record is always visible. The descriptor has
the reference's keys.

``REPRO_TORCH_TUNING_DISABLE=1`` skips the cache entirely (the built-in
defaults win); the reference's ``REPRO_TUNING_DISABLE`` does not move
the port.
"""
from __future__ import annotations

import os

from ..kernels import config as kconfig
from .cache import cache_key, device_kind, load_default_cache, \
    quantize_vertices
from .space import schema_hash

__all__ = ["resolve_engine_options", "tuning_enabled"]


def tuning_enabled() -> bool:
    return os.environ.get("REPRO_TORCH_TUNING_DISABLE") != "1"


def resolve_engine_options(opts, *, backend: str | None = None,
                           n_vertices: int | None = None, device=None
                           ) -> tuple[dict, dict]:
    """Concrete engine knobs for ``opts`` plus the consumed-record
    descriptor.

    Every knob in ``ENGINE_TUNABLE_DEFAULTS`` the caller left ``None``
    on ``opts`` is filled from the tuning-cache record keyed by
    ``(backend, device kind, quantized |V|)`` when one matches the
    current knob schema, else from the built-in default. Explicit
    values on ``opts`` always win. ``block_f`` resolves kernel-scope
    override > record > built-in (``kernels.config.kernel_block_f``).
    ``backend`` None means the backend of ``device`` (default: the
    card).
    """
    from ..api.options import ENGINE_TUNABLE_DEFAULTS

    backend = backend or kconfig.device_backend(device)
    rec = None
    key = None
    if tuning_enabled() and n_vertices is not None:
        key = cache_key(backend, device_kind(device), n_vertices)
        rec = load_default_cache().lookup_key(key)
    rec_params = rec.get("params", {}) if rec else {}

    knobs = {}
    filled_from_cache = []
    for name, default in ENGINE_TUNABLE_DEFAULTS.items():
        explicit = getattr(opts, name, None)
        if explicit is not None:
            knobs[name] = int(explicit)
        elif name in rec_params:
            knobs[name] = int(rec_params[name])
            filled_from_cache.append(name)
        else:
            knobs[name] = int(default)
    knobs["block_f"] = kconfig.kernel_block_f(backend, n_vertices, device)
    if kconfig.kernel_override("block_f") is None and "block_f" in rec_params:
        filled_from_cache.append("block_f")

    record = {
        "source": "tuning-cache" if rec else "builtin",
        "record": rec["name"] if rec else None,
        "key": key,
        "schema_hash": schema_hash(),
        "backend": backend,
        "v_bucket": (quantize_vertices(n_vertices)
                     if n_vertices is not None else None),
        "filled_from_cache": filled_from_cache,
        "params": dict(knobs),
    }
    return knobs, record
