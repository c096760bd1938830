"""Knob resolution for the port: explicit user value > built-in default.

The port has no tuning cache yet, so every tunable knob the caller left
``None`` gets its ``ENGINE_TUNABLE_DEFAULTS`` entry and ``block_f`` gets
the built-in row-block height. The returned descriptor always reports
``{"source": "builtin"}``.
"""
from __future__ import annotations

from ..kernels import config as kconfig

__all__ = ["resolve_engine_options"]


def resolve_engine_options(opts, *, backend: str | None = None,
                           n_vertices: int | None = None
                           ) -> tuple[dict, dict]:
    """Concrete engine knobs for ``opts`` plus the record descriptor."""
    from ..api.options import ENGINE_TUNABLE_DEFAULTS

    knobs = {}
    for name, default in ENGINE_TUNABLE_DEFAULTS.items():
        explicit = getattr(opts, name, None)
        knobs[name] = int(explicit if explicit is not None else default)
    knobs["block_f"] = kconfig.DEFAULT_BLOCK_F
    record = {"source": "builtin", "record": None, "backend": backend,
              "n_vertices": n_vertices, "filled_from_cache": [],
              "params": dict(knobs)}
    return knobs, record
