"""Kernel & schedule autotuning of the port.

Three layers:

* ``space``   — declarative :class:`TunableSpace` over the hot-path
  knobs, with validity constraints (Hopper's shared-memory and
  device-memory budgets among them) that reject invalid points before
  anything is built;
* ``cache``   — the persistent versioned ``TUNING_CACHE_TORCH.json``
  keyed by ``(backend, device_kind, quantized graph size)`` with
  schema-hash staleness detection;
* ``resolve`` — the one resolution funnel (explicit arg > MatchOptions
  > tuning cache > built-in default) that ``WaveScheduler`` consults at
  construction.

``measure`` and ``autotune`` (the CLI: ``python -m
repro_torch.tuning.autotune --smoke``) import the engine lazily so this
package stays importable without it.
"""
from .cache import (TuningCache, cache_key, default_cache_path,
                    device_kind, load_default_cache, quantize_vertices)
from .resolve import resolve_engine_options, tuning_enabled
from .space import (CandidateConfig, TunableSpace, WorkloadShape,
                    schema_hash)

__all__ = [
    "TunableSpace", "CandidateConfig", "WorkloadShape", "schema_hash",
    "TuningCache", "cache_key", "quantize_vertices", "device_kind",
    "default_cache_path", "load_default_cache",
    "resolve_engine_options", "tuning_enabled",
]
