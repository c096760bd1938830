"""Persistent tuning cache of the port: best-config records keyed by
``(backend, device_kind, quantized graph size)`` in a versioned JSON
file (``TUNING_CACHE_TORCH.json`` at the repo root, override with
``REPRO_TORCH_TUNING_CACHE``). The reference's ``TUNING_CACHE.json`` and
its ``REPRO_TUNING_CACHE`` never move the port.

Keys look like ``cuda/nvidia-h100-80gb-hbm3/v128`` (the CUDA kernels on
that card) and ``torch/cpu/v128`` (the plain versions on the host).

Staleness: every record carries the knob-schema hash it was tuned
under (``tuning/space.py``). A lookup under a different schema returns
a miss — a schema change silently invalidates every stale record
instead of resolving knobs whose meaning moved.

Key quantization: the data-graph vertex count is bucketed to the next
power of two, so one tuned record covers the workload-shape
neighborhood it was measured in.
"""
from __future__ import annotations

import json
import os
import pathlib
import threading

from .space import schema_hash

__all__ = ["TuningCache", "cache_key", "quantize_vertices",
           "device_kind", "default_cache_path", "load_default_cache"]

CACHE_VERSION = 1
_ENV_PATH = "REPRO_TORCH_TUNING_CACHE"


def default_cache_path() -> pathlib.Path:
    env = os.environ.get(_ENV_PATH)
    if env:
        return pathlib.Path(env)
    # src/repro_torch/tuning/cache.py -> repo root
    return pathlib.Path(__file__).resolve().parents[3] / \
        "TUNING_CACHE_TORCH.json"


def quantize_vertices(n_vertices: int) -> int:
    """Bucket |V| to the next power of two (minimum 32)."""
    v = max(32, int(n_vertices))
    return 1 << (v - 1).bit_length()


def device_kind(device=None) -> str:
    """Normalized kind of ``device`` (default: the card, as every entry
    point's; it raises without one): ``torch.cuda.get_device_name``
    lower-cased with spaces as dashes (``"nvidia-h100-80gb-hbm3"``),
    ``"cpu"`` for the host."""
    import torch

    from ..kernels.config import resolve_device
    dev = resolve_device() if device is None else torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(dev)
    return str(name).strip().lower().replace(" ", "-")


def cache_key(backend: str, dev_kind: str, n_vertices: int) -> str:
    return f"{backend}/{dev_kind}/v{quantize_vertices(n_vertices)}"


class TuningCache:
    """Read/write view over one cache file.

    File shape::

        {"version": 1,
         "schema_hash": "<knob-schema digest>",
         "records": {
           "cuda/nvidia-h100-80gb-hbm3/v128": {
               "name": "cuda/nvidia-h100-80gb-hbm3/v128",
               "schema_hash": "...",
               "params": {"block_f": 8, ...},
               "measured": {"qps": ..., ...}}}}
    """

    def __init__(self, path: pathlib.Path | str | None = None):
        self.path = pathlib.Path(path) if path is not None \
            else default_cache_path()
        self._lock = threading.Lock()
        self._data = self._load()

    def _load(self) -> dict:
        try:
            data = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            data = {}
        if (not isinstance(data, dict)
                or data.get("version") != CACHE_VERSION
                or not isinstance(data.get("records"), dict)):
            data = {"version": CACHE_VERSION,
                    "schema_hash": schema_hash(), "records": {}}
        return data

    # -- reads ---------------------------------------------------------
    def records(self) -> dict:
        return dict(self._data["records"])

    def lookup_key(self, key: str) -> dict | None:
        """The record under ``key``, or None on a miss *or* a schema
        mismatch (stale record — tuned under a different knob schema)."""
        rec = self._data["records"].get(key)
        if not isinstance(rec, dict):
            return None
        if rec.get("schema_hash") != schema_hash():
            return None
        if not isinstance(rec.get("params"), dict):
            return None
        return rec

    def lookup(self, backend: str, dev_kind: str,
               n_vertices: int) -> dict | None:
        return self.lookup_key(cache_key(backend, dev_kind, n_vertices))

    # -- writes --------------------------------------------------------
    def put(self, backend: str, dev_kind: str, n_vertices: int,
            params: dict, measured: dict | None = None) -> dict:
        """Insert/replace the best-config record for one key and persist
        the file. Returns the stored record."""
        key = cache_key(backend, dev_kind, n_vertices)
        rec = {"name": key, "schema_hash": schema_hash(),
               "params": {k: int(v) for k, v in params.items()},
               "measured": dict(measured or {})}
        with self._lock:
            self._data["schema_hash"] = schema_hash()
            self._data["records"][key] = rec
            self.path.write_text(
                json.dumps(self._data, indent=2, sort_keys=True) + "\n")
        return rec


# In-memory default-cache singleton, invalidated on a change of path or
# file mtime (WaveScheduler construction consults it: a JSON parse per
# scheduler would be noise, a parse per file change is free).
_default_cache: TuningCache | None = None
_default_mtime: float | None = None
_default_lock = threading.Lock()


def load_default_cache() -> TuningCache:
    global _default_cache, _default_mtime
    path = default_cache_path()
    try:
        mtime = path.stat().st_mtime
    except OSError:
        mtime = None
    with _default_lock:
        if (_default_cache is None or _default_mtime != mtime
                or _default_cache.path != path):
            _default_cache = TuningCache(path)
            _default_mtime = mtime
        return _default_cache
