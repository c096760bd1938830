"""Declarative search space for the port's kernel & schedule autotuner.

A :class:`TunableSpace` enumerates candidate configurations over the
engine's hot-path knobs — the same names and domains as the reference
(``repro/tuning/space.py``), so a record has the same ``params`` keys —
and rejects invalid points *before* anything is built or launched:

* pow-2 constraints (``wave_size``, ``stack_capacity``,
  ``pattern_capacity``) — the store's open-addressing mask and the
  stack ring arithmetic require them;
* ``pattern_capacity >= PROBE`` (the linear probe window must fit);
* ``stack_capacity >= wave_size`` (a wave of fresh roots fits a bank);
* ``chunk_words`` a power of two in [1, 128], every knob >= 1.

What binds on Hopper replaces the reference's VMEM budget:

* **hier** (``hbm_adjacency=1``): the CUDA hierarchical refine keeps one
  row of W words and its positions' summary intersection in dynamic
  shared memory, ``4 * (4*ceil(W/4) + S)`` bytes with
  ``S = ceil(ceil(W/C)/32)`` (``kernels.bitmap_refine.hier_smem_bytes``),
  checked against the card's opt-in limit (read from the kernel library
  when a card is present, else :data:`HOPPER_SMEM_OPTIN_BYTES`);
* **dense** (``hbm_adjacency=0``): the ``[V, W]`` int32 adjacency is a
  device tensor, so its ``V * W * 4`` bytes are checked against a
  device-memory budget: :data:`DENSE_MEMORY_SHARE` of the card's
  memory, or :data:`DEFAULT_DENSE_BUDGET_BYTES` without a card.

No rule reads ``block_f`` or ``dma_depth``: neither CUDA refine does.
They stay in the schema for parity with the reference's records.

The schema hash over this definition is the staleness key for the
port's cache file: it carries the port's own ``constraints`` version,
so a record tuned under the reference's rules never resolves here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json

__all__ = ["CandidateConfig", "TunableSpace", "WorkloadShape",
           "schema_hash", "HOPPER_SMEM_OPTIN_BYTES",
           "DEFAULT_DENSE_BUDGET_BYTES", "DENSE_MEMORY_SHARE"]

# The store's linear probe window (patterns/store.py PROBE); pinned
# equal by tests/test_torch_tuning.py.
PROBE = 8

# What refine_bitmap_rows_hier_max_smem() returns on an H100: the 227 KB
# per-block opt-in (232448 B) less the kernel's 4096 B of static shared
# memory. The limit used when no card can be asked.
HOPPER_SMEM_OPTIN_BYTES = 228352

# Share of the card's memory the dense [V, W] adjacency may take: the
# query, pattern-store and stack banks and the megastep's lanes share
# the card with it.
DENSE_MEMORY_SHARE = 0.25
# The dense budget without a card (the plain versions on the host).
DEFAULT_DENSE_BUDGET_BYTES = 4 << 30

# The knob schema the cache's staleness hash covers: names, domains and
# the constraint version. Bump ``constraints`` whenever a validity rule
# changes meaning — every cached record becomes stale at once.
_SCHEMA = {
    "version": 1,
    "constraints": "hopper-1",
    "knobs": {
        "block_f": [4, 8, 16, 32],
        "megastep_depth": [1, 2, 4, 6, 8, 12],
        "wave_size": [32, 64, 128, 256, 512, 1024],
        "n_slots": [1, 2, 4, 8, 16, 32, 64],
        "stack_capacity": [256, 512, 1024, 2048, 4096],
        "pattern_capacity": [64, 128, 256, 512, 1024, 2048, 4096],
        "store_flush_min": [1, 8, 16, 32, 64],
        "hbm_adjacency": [0, 1],
        "chunk_words": [1, 2, 4, 8, 16, 32],
        "dma_depth": [1, 2, 4],
    },
}

KNOB_NAMES = tuple(sorted(_SCHEMA["knobs"]))


def schema_hash() -> str:
    """Digest of the knob schema — the cache staleness key."""
    blob = json.dumps(_SCHEMA, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def _is_pow2(v: int) -> bool:
    return v >= 1 and (v & (v - 1)) == 0


@dataclasses.dataclass(frozen=True)
class WorkloadShape:
    """The quantities the validity constraints need: data-graph vertex
    count (``v``), packed bitmap word width (``w``), and the widest
    query the engine pads to (``n_pad``)."""
    v: int
    w: int
    n_pad: int = 64

    @staticmethod
    def for_graph(n_vertices: int, n_pad: int = 64) -> "WorkloadShape":
        return WorkloadShape(v=int(n_vertices),
                             w=(int(n_vertices) + 31) // 32,
                             n_pad=n_pad)


@dataclasses.dataclass(frozen=True)
class CandidateConfig:
    """One point of the search space. ``as_params()`` is the dict shape
    the cache records and the resolution layer consume."""
    block_f: int = 8
    megastep_depth: int = 6
    wave_size: int = 512
    n_slots: int = 8
    stack_capacity: int = 1024
    pattern_capacity: int = 1024
    store_flush_min: int = 16
    hbm_adjacency: int = 0
    chunk_words: int = 8
    dma_depth: int = 2

    def as_params(self) -> dict:
        return {k: int(getattr(self, k)) for k in KNOB_NAMES}


def dense_adjacency_bytes(shape: WorkloadShape) -> int:
    """Bytes of the dense int32 ``[V, W]`` adjacency on the device."""
    return shape.v * shape.w * 4


def hier_refine_smem_bytes(shape: WorkloadShape, chunk_words: int) -> int:
    """Dynamic shared memory of the CUDA hierarchical refine at
    ``shape`` with ``chunk_words``-word chunks."""
    from ..kernels.bitmap_refine import hier_smem_bytes
    n_chunks = -(-max(shape.w, 1) // chunk_words)
    return hier_smem_bytes(shape.w, -(-n_chunks // 32))


def _card_limits() -> tuple[int, int]:
    """(shared-memory opt-in limit, dense budget) of the card, or the
    constants without one."""
    import torch
    if not torch.cuda.is_available():
        return HOPPER_SMEM_OPTIN_BYTES, DEFAULT_DENSE_BUDGET_BYTES
    from ..kernels.bitmap_refine import hier_max_smem
    total = torch.cuda.get_device_properties(0).total_memory
    return hier_max_smem(), int(total * DENSE_MEMORY_SHARE)


class TunableSpace:
    """Candidate enumeration + validity checking for one backend at one
    workload shape. ``smem_limit_bytes`` / ``dense_budget_bytes`` default
    to the card's (backend ``"cuda"`` with a card present) or to the
    constants above."""

    def __init__(self, backend: str, shape: WorkloadShape,
                 smem_limit_bytes: int | None = None,
                 dense_budget_bytes: int | None = None):
        self.backend = backend
        self.shape = shape
        if smem_limit_bytes is None or dense_budget_bytes is None:
            smem, dense = (_card_limits() if backend == "cuda" else
                           (HOPPER_SMEM_OPTIN_BYTES,
                            DEFAULT_DENSE_BUDGET_BYTES))
            smem_limit_bytes = (smem if smem_limit_bytes is None
                                else smem_limit_bytes)
            dense_budget_bytes = (dense if dense_budget_bytes is None
                                  else dense_budget_bytes)
        self.smem_limit_bytes = int(smem_limit_bytes)
        self.dense_budget_bytes = int(dense_budget_bytes)
        self.rejected: list[tuple[CandidateConfig, str]] = []

    # -- validity ------------------------------------------------------
    def validate(self, cfg: CandidateConfig) -> str | None:
        """``None`` when ``cfg`` is admissible, else the rejection
        reason. Pure shape arithmetic — nothing here builds or
        launches."""
        for name in ("block_f", "megastep_depth", "wave_size", "n_slots",
                     "stack_capacity", "pattern_capacity",
                     "store_flush_min", "chunk_words", "dma_depth"):
            if getattr(cfg, name) < 1:
                return f"{name} must be >= 1"
        if cfg.hbm_adjacency not in (0, 1):
            return f"hbm_adjacency={cfg.hbm_adjacency} must be 0 or 1"
        if cfg.chunk_words > 128 or not _is_pow2(cfg.chunk_words):
            return (f"chunk_words={cfg.chunk_words} must be a power of "
                    "two in [1, 128] (summary packs one bit per chunk "
                    "into u32 words)")
        for name in ("wave_size", "stack_capacity", "pattern_capacity"):
            if not _is_pow2(getattr(cfg, name)):
                return f"{name}={getattr(cfg, name)} is not a power of two"
        if cfg.pattern_capacity < PROBE:
            return (f"pattern_capacity={cfg.pattern_capacity} below the "
                    f"probe window ({PROBE})")
        if cfg.stack_capacity < cfg.wave_size:
            return (f"stack_capacity={cfg.stack_capacity} below "
                    f"wave_size={cfg.wave_size} (a full wave of fresh "
                    "roots must fit one stack bank)")
        if cfg.hbm_adjacency:
            need = hier_refine_smem_bytes(self.shape, cfg.chunk_words)
            if need > self.smem_limit_bytes:
                return (f"hier refine shared memory {need} B exceeds the "
                        f"opt-in limit {self.smem_limit_bytes} B at "
                        f"V={self.shape.v}")
            return None
        need = dense_adjacency_bytes(self.shape)
        if need > self.dense_budget_bytes:
            return (f"dense adjacency {need} B exceeds the device-memory "
                    f"budget {self.dense_budget_bytes} B at "
                    f"V={self.shape.v}")
        return None

    # -- enumeration ---------------------------------------------------
    def candidates(self, overrides: dict[str, list] | None = None
                   ) -> list[CandidateConfig]:
        """Valid candidates from the cross product of the knob domains
        (``overrides`` narrows any knob's domain). Invalid points land
        in ``self.rejected`` with their reason."""
        domains = {k: list(v) for k, v in _SCHEMA["knobs"].items()}
        for k, vals in (overrides or {}).items():
            if k not in domains:
                raise KeyError(f"unknown tunable knob {k!r}; "
                               f"known: {sorted(domains)}")
            domains[k] = list(vals)
        out = []
        names = KNOB_NAMES
        for values in itertools.product(*(domains[n] for n in names)):
            cfg = CandidateConfig(**dict(zip(names, values)))
            reason = self.validate(cfg)
            if reason is None:
                out.append(cfg)
            else:
                self.rejected.append((cfg, reason))
        return out
