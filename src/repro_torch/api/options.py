"""The single source of truth for every matching knob (DESIGN.md §4).

Before this module existed the engine/budget knobs (``limit``,
``time_budget_s``, ``max_recursions``, ``parallelism``, ``wave_size``,
``megastep_depth``, ``pattern_*``, …) were duplicated with drifting
defaults across four kwarg surfaces: ``QueryServer``,
``WaveScheduler.submit``, ``DistributedMatcher`` and ``WaveEngine``.
:class:`MatchOptions` collapses them into one dataclass, validated in
one place; every entry point resolves its keyword arguments through
:meth:`MatchOptions.resolve` so a default changed here changes
everywhere (asserted by ``tests/test_api.py``).

This module is deliberately leaf-level: it imports nothing from
``repro_torch.core`` so the core scheduler can consume it without an import
cycle.

Two kinds of field share the dataclass because requests and engines
share a vocabulary:

* **per-query** fields travel on a :class:`MatchRequest` and may differ
  between concurrent queries (``limit``, ``time_budget_s``,
  ``max_recursions``, ``use_pruning``, ``parallelism``, ``priority``,
  ``seed_patterns``, ``keep_table``);
* **per-engine** fields are consumed once at scheduler construction
  (``n_slots``, ``wave_size``, ``kpr``, ``megastep_depth``,
  ``max_queue``, ``store_*``, ``adaptive_prune_threshold``,
  ``device_stacks``, ``stack_capacity``, ``pattern_*``,
  ``hit_decay_every``) and ignored on a request.

An engine built from a ``MatchOptions`` also uses it as the *default*
per-query options for requests that do not override them — so a server
constructed with ``limit=100`` serves every query with that cap unless
the request says otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:                                    # pragma: no cover
    from ..core.graph import Graph

__all__ = ["MatchOptions", "MatchRequest", "ENGINE_TUNABLE_DEFAULTS"]

# accepted spellings of historical kwargs -> canonical field
_ALIASES = {"max_rows": "max_recursions"}

# Engine knobs the autotuner may fill (DESIGN.md §9). Their MatchOptions
# default is ``None`` = "let the tuning layer decide"; the values below
# are the built-in fallback when no tuning record matches. An explicit
# user value always wins over both (pinned by tests/test_tuning.py).
# ``pattern_capacity`` was right-sized from 4096 by measurement: the
# serving workloads peak near ~130 resident patterns per slot (corridor,
# 128 baits), so 4096 ran at load factor 0.004 on uniform traffic —
# capacity paid for but unused. 1024 keeps 8x headroom over the heaviest
# measured workload, and eviction is sound anyway (loses pruning, never
# results).
ENGINE_TUNABLE_DEFAULTS = {
    "n_slots": 8,
    "wave_size": 512,
    "megastep_depth": 6,
    "store_flush_min": 16,
    "stack_capacity": 1024,
    "pattern_capacity": 1024,
}


@dataclasses.dataclass(frozen=True)
class MatchOptions:
    """Every per-query and per-engine matching knob, with the one
    canonical default per knob. Frozen: derive variants with
    :meth:`replace` / :meth:`resolve`."""

    # ---- per-query ----------------------------------------------------
    limit: int | None = 1000          # result cap (None = enumerate all)
    time_budget_s: float | None = None   # wall-clock budget
    max_recursions: int | None = None    # recursion/row budget
    use_pruning: bool | None = None      # None = engine default (True)
    parallelism: int = 1              # intra-query shards (DESIGN.md §3)
    priority: int = 0                 # admission priority (higher first)
    keep_table: bool = False          # export the learned Δ on finish
    seed_patterns: dict | None = None  # entries dict to warm-start Δ

    # ---- per-engine (consumed at scheduler construction) --------------
    # ``None`` on a tunable knob means "resolve through the tuning layer"
    # (tuning cache record for this backend/shape, else the built-in
    # ENGINE_TUNABLE_DEFAULTS entry — DESIGN.md §9). Explicit values win.
    n_slots: int | None = None
    wave_size: int | None = None
    kpr: int = 16
    megastep_depth: int | None = None
    max_queue: int = 4096
    store_flush_min: int | None = None
    store_pad: int = 256
    adaptive_prune_threshold: float = 0.05
    # device-resident frontier stacks (DESIGN.md §2): per-slot DFS stack
    # depth held in device arrays. ``device_stacks=False`` forces every
    # query through the host SegmentPool path (debug / A-B testing).
    device_stacks: bool = True
    stack_capacity: int | None = None
    # hierarchical / HBM-resident adjacency (DESIGN.md §2): ``None`` on
    # every knob means "resolve through kernels.config" — the
    # ``use_hbm_adjacency`` size threshold (or a tuning record) picks
    # the layout, and ``chunk_words`` / ``dma_depth`` fill from the
    # tuned kernel parameters. Explicit values pin the variant — e.g.
    # ``hier_adjacency=True`` forces the two-level layout on a small
    # graph for A/B and bit-identity testing.
    hier_adjacency: bool | None = None
    chunk_words: int | None = None    # packed words per chunk (C, pow-2)
    dma_depth: int | None = None      # in-flight chunk copies (HBM kernel)
    pattern_capacity: int | None = None
    pattern_cache: bool = True
    pattern_cache_templates: int = 64
    pattern_cache_top_k: int = 512
    hit_decay_every: int = 256
    # ---- fault tolerance (DESIGN.md §8) -------------------------------
    # Watchdog deadline per device/megastep dispatch (None = off: a
    # first dispatch legitimately spends tens of seconds in jit
    # compilation). A dispatch past the deadline is treated as hung:
    # its digest is untrusted and the involved queries are demoted.
    dispatch_timeout_s: float | None = None
    dispatch_retries: int = 2         # re-dispatch attempts on failure
    retry_backoff_s: float = 0.05     # base of the exponential backoff
    validate_digests: bool = True     # check DeviceResult invariants
    fallback_on_failure: bool = True  # demote failing queries to host
    max_query_failures: int = 2       # failures before status="error"
    shed_policy: str = "reject"       # "reject" (QueueFull) | "shed_lowest"
    micro_checkpoint_every: int | None = None  # distributed waves/ckpt
    faults: Any = None                # core.faults.FaultPlan (tests/chaos)

    # ------------------------------------------------------------------
    def validate(self) -> "MatchOptions":
        """Raise ``ValueError`` on an inconsistent knob; returns self."""
        def _nonneg(name: str, v, allow_none: bool = True) -> None:
            if v is None:
                if not allow_none:
                    raise ValueError(f"{name} may not be None")
                return
            if v < 0:
                raise ValueError(f"{name} must be >= 0, got {v!r}")

        _nonneg("limit", self.limit)
        _nonneg("time_budget_s", self.time_budget_s)
        _nonneg("max_recursions", self.max_recursions)
        if self.parallelism < 1:
            raise ValueError(
                f"parallelism must be >= 1, got {self.parallelism!r}")
        for name in ("n_slots", "wave_size", "kpr", "megastep_depth",
                     "max_queue", "store_pad", "pattern_capacity",
                     "hit_decay_every", "stack_capacity",
                     "store_flush_min"):
            v = getattr(self, name)
            if v is None and name in ENGINE_TUNABLE_DEFAULTS:
                continue              # tunable: resolved at construction
            if v is None or v < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)!r}")
        if (self.pattern_capacity is not None
                and self.pattern_capacity & (self.pattern_capacity - 1)):
            raise ValueError("pattern_capacity must be a power of two, "
                             f"got {self.pattern_capacity!r}")
        if self.chunk_words is not None and (
                self.chunk_words < 1 or self.chunk_words > 128
                or self.chunk_words & (self.chunk_words - 1)):
            raise ValueError("chunk_words must be a power of two in "
                             f"[1, 128], got {self.chunk_words!r}")
        if self.dma_depth is not None and self.dma_depth < 1:
            raise ValueError(
                f"dma_depth must be >= 1, got {self.dma_depth!r}")
        _nonneg("dispatch_timeout_s", self.dispatch_timeout_s)
        _nonneg("retry_backoff_s", self.retry_backoff_s, allow_none=False)
        _nonneg("dispatch_retries", self.dispatch_retries,
                allow_none=False)
        _nonneg("max_query_failures", self.max_query_failures,
                allow_none=False)
        if self.shed_policy not in ("reject", "shed_lowest"):
            raise ValueError("shed_policy must be 'reject' or "
                             f"'shed_lowest', got {self.shed_policy!r}")
        if (self.micro_checkpoint_every is not None
                and self.micro_checkpoint_every < 1):
            raise ValueError("micro_checkpoint_every must be >= 1, got "
                             f"{self.micro_checkpoint_every!r}")
        return self

    def replace(self, **overrides: Any) -> "MatchOptions":
        """``dataclasses.replace`` with alias normalization + validation."""
        return MatchOptions.resolve(self, **overrides)

    @staticmethod
    def resolve(base: "MatchOptions | None" = None,
                **overrides: Any) -> "MatchOptions":
        """The one resolution path every entry point funnels through.

        ``base`` supplies defaults (``None`` = the canonical
        ``MatchOptions()``); ``overrides`` are explicitly-passed kwargs
        — *presence* marks an override, so ``limit=None`` genuinely
        overrides a numeric default. Unknown keys raise ``TypeError``
        (the historical ``max_rows`` spelling is folded into
        ``max_recursions``)."""
        kw = {}
        for k, v in overrides.items():
            kw[_ALIASES.get(k, k)] = v
        opts = base if base is not None else MatchOptions()
        if kw:
            opts = dataclasses.replace(opts, **kw)
        return opts.validate()

    def resolved_engine(self, *, backend: str | None = None,
                        n_vertices: int | None = None, device=None
                        ) -> tuple[dict, dict]:
        """Concrete engine knobs + the tuning record that supplied them.

        Fills every tunable knob the caller left ``None`` from the
        port's tuning cache (``tuning/resolve.py``: keyed by backend /
        device kind / quantized data-graph size), falling back to
        ``ENGINE_TUNABLE_DEFAULTS``. Explicit values on this options
        object always win over the cache. ``backend`` None means the
        backend of ``device``'s kernels. Returns ``(knobs, record)``
        where ``knobs`` maps every ENGINE_TUNABLE_DEFAULTS key (plus
        ``block_f``, the refine row-block height) to an int and
        ``record`` is a JSON-safe descriptor naming the consumed tuning
        record (``source`` = "tuning-cache" | "builtin")."""
        from ..tuning.resolve import resolve_engine_options
        return resolve_engine_options(self, backend=backend,
                                      n_vertices=n_vertices, device=device)


@dataclasses.dataclass
class MatchRequest:
    """One query plus its resolved options — the unit the request/handle
    API submits. ``request_id`` is the caller-visible id (defaults to
    the scheduler-assigned query id); ``cand``/``order`` optionally pin
    the candidate sets / matching order (oracle tests, shard restriction
    in ``core.distributed``)."""
    query: "Graph"
    options: MatchOptions
    request_id: int | None = None
    cand: list | None = None
    order: Any | None = None

    def __post_init__(self) -> None:
        self.options.validate()
