"""Host-side shared-wave scheduler in PyTorch.

Twin of ``repro/core/vectorized.py`` (DESIGN.md §2). Queries are
admitted into bank slots and share fixed-shape device waves. Plain
queries (parallelism 1, no table export) keep their whole DFS stack in
device tensors: each ``step()`` dispatches one
:func:`run_device_megastep` (double-buffered: dispatch *i+1* goes out
before dispatch *i*'s digest is folded), and only a per-slot scalar
digest and the embedding rows come back to the host. Everything else —
``keep_table``, ``parallelism > 1``, ``device_stacks=False``,
``megastep_depth <= 1``, and a device stack that wedged and was exported
back to the host — runs on host segments (``segments.py``) through the
host-scheduled programs: the fused :func:`run_megastep_mq` ring, the
single-step :func:`expand_wave_mq`, and the leftover pass
:func:`extract_more_mq`. Admission, streaming delivery, limits,
budgets, cancellation, the adaptive-depth prune EMA, hit aging and the
cross-query template cache behave as in the reference, so per-query
results and counters match it.

``device`` (default ``"cuda"``) places every bank; without a card the
default raises. The adjacency layout is picked at construction as in the
reference: the dense packed block below 16384 data-graph vertices
(``"dense-vmem"`` in ``scheduler_stats()``), the two-level layout of
``core.graph.HierBitmap`` at or above it (``"hier-hbm"``), unless
``hier_adjacency`` pins one; every refine then goes through the dense or
the hierarchical kernel.

Fault tolerance (DESIGN.md §8) is the reference's: a ``FaultPlan``
(``core.faults``) pokes the dispatch, digest, flush and admission
boundaries; a failing dispatch is retried with backoff, then its queries
are quarantined and the banks rebuilt on ``self.device``; a hung or
late dispatch (``dispatch_timeout_s``) and a digest that fails
validation quarantine the queries they involve. A quarantined query is
replayed from its request on the host-scheduled programs (``host_only``:
host segments, one work item per wave) on the same device, so its
refines still launch the kernel, deduplicating against the embeddings it
had already found; past ``max_query_failures`` (or with
``fallback_on_failure=False``) it ends with status ``"error"``.

Where this departs from the reference: only ``core.faults.
DISPATCH_ERRORS`` is caught (any other runtime error, a CUDA fault among
them, propagates out of ``step()``); a dispatch here updates the banks
in place and runs to its end inside the call, so a real
``torch.OutOfMemoryError`` rebuilds the Δ bank before a host-megastep
retry and quarantines at once on the device-stack path, and the
watchdog reads a dispatch's own seconds (the call plus its digest
read); a stack-bank rebuild quarantines every device query, not only
the failed dispatch's (one admitted while it was in flight would lose
its frontier); and ``step()`` counts queued replays as progress.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import time

import numpy as np
import torch

from ..api.options import MatchOptions
from ..kernels.config import (device_backend, kernel_chunk_words,
                              kernel_dma_depth, resolve_device,
                              use_hbm_adjacency)
from ..patterns import (DeadEndStats, PatternCache, PatternStore,
                        PatternStoreBank, age_hits, empty_entries,
                        entries_to_store, store_to_entries)
from .backtrack import MatchResult, _prepare
from .faults import DISPATCH_ERRORS, FaultInjected, corrupt_digest
from .engine_step import (N_PAD, STK_FREE, STK_FRESH, STK_LEFT, STK_RES,
                          STK_WAIT, DeviceResult, GraphArrays, MegaResult,
                          QueryBank, StackBank, assemble_children_mq,
                          clear_slot_stack, clear_slot_stacks,
                          expand_wave_mq, extract_more_mq, load_slot,
                          load_slots, read_store_slot, run_device_megastep,
                          run_megastep_mq, store_patterns_mq)
from .graph import Graph, pack_bitmap
from .segments import (EngineStats, QueryState, Segment, SegmentPool,
                       WorkItem, below, bit_of, mask64, words_from64)

_log = logging.getLogger(__name__)

__all__ = ["WaveScheduler", "WaveEngine", "EngineStats", "QueueFull",
           "match_vectorized"]


class QueueFull(RuntimeError):
    """Raised when the bounded admission queue rejects a submission."""


# per-slot scalar lanes of a DeviceResult digest
_DEV_LANES = ("d_accepted", "d_expanded", "d_rows", "d_prunes", "d_inj",
              "d_stored", "d_pending", "d_live", "d_outsum",
              "d_childlive")
_PAT_LANES = ("pat_stored", "pat_overwrites", "pat_evictions",
              "pat_dropped")


def _i32(a: np.ndarray, device) -> torch.Tensor:
    """numpy (u)int32 / bool array -> tensor on ``device`` (uint32 words
    are reinterpreted as int32 bit patterns)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _words(t: torch.Tensor) -> np.ndarray:
    """Packed int32 word tensor -> the host's uint32 words."""
    return _np(t).view(np.uint32)


@dataclasses.dataclass
class _Request:
    """A prepared query waiting in the admission queue."""
    query_id: int
    n: int
    order: np.ndarray
    roots: np.ndarray
    cand_bitmap: np.ndarray        # uint32 [N_PAD, W]
    nbr_mask: np.ndarray           # bool [N_PAD, N_PAD]
    qnbr_bits: np.ndarray          # uint64 [N_PAD]
    limit: int | None
    learn: bool
    max_rows: int | None
    time_budget_s: float | None
    seed_patterns: dict | None     # entries dict (patterns.store)
    keep_table: bool
    t_submit: float
    fingerprint: bytes | None
    parallelism: int = 1
    priority: int = 0
    on_embeddings: object | None = None
    # degraded-mode replay (DESIGN.md §8): a quarantined query is
    # re-admitted as a fresh request on the host-scheduled path,
    # carrying the embeddings it already found (deduplicated on replay)
    # and its failure count
    host_only: bool = False
    fail_count: int = 0
    prior_embeddings: list | None = None   # [n_query] int32 rows
    emb_seen: set | None = None            # tobytes() of every prior row
    prior_rows: int = 0                    # rows_created before demotion
    prior_ttfe: float | None = None


@dataclasses.dataclass
class _Inflight:
    """A dispatched-but-unread host-scheduled wave."""
    kind: str                      # "mega" | "leftover"
    res: object                    # MegaResult | extract_more_mq tuple
    metas: list                    # [(q, seg, s, e, woff, k, shard)]
    slot_map: dict                 # slot -> QueryState at dispatch time
    fr: np.ndarray | None = None   # leftover kind: packed inputs for
    us: np.ndarray | None = None   # host-side child assembly
    ph: np.ndarray | None = None
    depth_v: np.ndarray | None = None
    busy_s: float = 0.0            # the dispatch call's own seconds
    hung: bool = False             # injected hang: digest untrusted


@dataclasses.dataclass
class _InflightDev:
    """A dispatched-but-unread device-resident dispatch."""
    res: DeviceResult
    slot_map: dict                 # slot -> QueryState at dispatch time
    root_slots: tuple              # slots whose root batch rode along
    t_max: int
    busy_s: float = 0.0            # the dispatch call's own seconds
    hung: bool = False             # injected hang: digest untrusted


class WaveScheduler:
    """Continuous multi-query matching over one data graph.

    Usage::

        sched = WaveScheduler(data_graph, n_slots=16, device="cuda")
        qid = sched.submit(query_graph, limit=1000)
        sched.run()
        res = sched.finished.pop(qid)          # MatchResult

    Every knob lives on :class:`repro_torch.api.MatchOptions`, field for
    field the reference's; ``device`` is a constructor keyword.
    """

    def __init__(self, data: Graph, *, options: MatchOptions | None = None,
                 device="cuda", **knobs):
        opts = MatchOptions.resolve(options, **knobs)
        self.device = resolve_device(device)
        self.options = opts
        self.data = data
        # tuning resolution: every tunable knob the caller left None
        # fills from the tuning cache record keyed by the backend this
        # device's kernels take, the device kind and |V|, else the
        # built-in default. Explicit values win.
        self._kernel_backend = device_backend(self.device)
        tuned, self.tuning_record = opts.resolved_engine(
            backend=self._kernel_backend, n_vertices=data.n,
            device=self.device)
        self.n_slots = tuned["n_slots"]
        self.wave_size = tuned["wave_size"]
        self.kpr = int(opts.kpr)
        self.use_pruning = (True if opts.use_pruning is None
                            else opts.use_pruning)
        self.max_queue = int(opts.max_queue)
        self.megastep_depth = tuned["megastep_depth"]
        self.store_flush_min = tuned["store_flush_min"]
        self.store_pad = int(opts.store_pad)
        self.pattern_capacity = tuned["pattern_capacity"]
        self.hit_decay_every = int(opts.hit_decay_every)
        self.pattern_cache = (
            PatternCache(opts.pattern_cache_templates,
                         opts.pattern_cache_top_k)
            if opts.pattern_cache else None)
        # deferred cache snapshots: a retiring learner's slot store is
        # copied on the device and folded into the cache only if the
        # same template is admitted again
        self._pending_snaps: collections.OrderedDict[bytes, tuple] = \
            collections.OrderedDict()
        self.warm_started = 0
        self.warm_patterns_seeded = 0
        self.store_counters = {"stored": 0, "overwrites": 0,
                               "evictions": 0, "dropped": 0}
        self._flush_ctr_dev = None          # StoreCounters sum of flushes
        self._last_aged_wave = 0
        self.adaptive_prune_threshold = float(
            opts.adaptive_prune_threshold)
        self._prune_ema = 1.0
        self._mega_kpr = 2 * self.kpr
        self._ring_capacity = 2 * self.wave_size * (self._mega_kpr + 1)
        self._emb_cap = 2 * self.wave_size * self._mega_kpr
        self.w = (data.n + 31) // 32
        # adjacency layout: the options pin wins, else kernels.config
        # (scope override > tuning record > the size threshold) decides.
        # The hierarchical layout never materialises the dense [V, W]
        # block (537 MB at 64K vertices).
        kb, dev = self._kernel_backend, self.device
        use_hier = (bool(opts.hier_adjacency)
                    if opts.hier_adjacency is not None
                    else use_hbm_adjacency(kb, data.n, dev))
        if use_hier:
            cw = (int(opts.chunk_words) if opts.chunk_words is not None
                  else kernel_chunk_words(kb, data.n, dev))
            # accepted for parity with the reference; the kernel does
            # not read it
            self.dma_depth = (int(opts.dma_depth)
                              if opts.dma_depth is not None
                              else kernel_dma_depth(kb, data.n, dev))
            hb = data.hier_bitmap(chunk_words=cw)
            self.chunk_words = cw
            self.g = GraphArrays(
                adj_bitmap=None, n_vertices=data.n,
                adj_summary=_i32(hb.summary, self.device),
                chunk_ptr=_i32(hb.chunk_ptr, self.device),
                chunk_id=_i32(hb.chunk_id, self.device),
                chunk_data=_i32(hb.chunk_data, self.device),
                kmax=hb.kmax)
            self.adjacency_variant = "hier-hbm"
            self.adjacency_bytes = int(hb.nbytes)
        else:
            self.chunk_words = 0
            self.dma_depth = None
            self.g = GraphArrays(
                adj_bitmap=_i32(data.adj_bitmap, self.device),
                n_vertices=data.n)
            self.adjacency_variant = "dense-vmem"
            self.adjacency_bytes = data.n * self.w * 4
        self.qb = QueryBank.empty(self.n_slots, self.w, self.device)
        self.tb = PatternStoreBank.empty(self.n_slots,
                                         self.pattern_capacity, self.device)
        self._empty_store = PatternStore.empty(self.pattern_capacity,
                                               self.device)
        self.pool = SegmentPool(self.n_slots)
        self.queue: collections.deque[_Request] = collections.deque()
        self.finished: dict[int, MatchResult] = {}
        self.tables: dict[int, dict] = {}   # keep_table Δ snapshots
        self._fresh_done: list[int] = []
        self._next_qid = 0
        self._rr = 0
        self._wave_kind: str | None = None
        self._inflight: _Inflight | None = None
        # plain parallelism-1 queries keep their DFS stack in device
        # tensors; keep_table / parallelism > 1 / single-step traffic
        # runs on host segments
        self._use_device = (bool(opts.device_stacks)
                            and self.megastep_depth > 1)
        self.stack_capacity = tuned["stack_capacity"]
        self.sb: StackBank | None = (
            StackBank.empty(self.n_slots, self.stack_capacity, self.w,
                            self.device)
            if self._use_device else None)
        self._inflight_dev: _InflightDev | None = None
        self.waves = 0
        self.rows_packed = 0
        self.occ_sum = 0.0
        self.waves_steady = 0
        self.occ_sum_steady = 0.0
        self.total_prunes = 0
        self.total_rows_created = 0
        self.total_steals = 0
        self.slot_rows_expanded = np.zeros(self.n_slots, np.int64)
        self.slot_children_created = np.zeros(self.n_slots, np.int64)
        # host/device time split; on this eager path a dispatch runs to
        # its end inside the call (its loop conditions are read back),
        # so dispatch time holds the device time too
        self.t_dispatch_s = 0.0
        self.t_sync_s = 0.0
        self.t_host_s = 0.0
        self.t_admit_s = 0.0
        self.t_digest_s = 0.0
        self.t_retire_s = 0.0
        self.t_flush_s = 0.0
        self.n_dispatches = 0
        self.n_exported = 0
        # expansion iterations (one Eq. 2 refine pass each: megastep
        # loop iterations plus single-step fresh waves) and the loop
        # conditions read back to the host
        self.timing = {"iterations": 0, "readbacks": 0, "readback_s": 0.0}
        # fault tolerance (DESIGN.md §8): every hook is gated on its
        # knob (or ``_faults is None``)
        self.dispatch_timeout_s = opts.dispatch_timeout_s
        self.dispatch_retries = int(opts.dispatch_retries)
        self.retry_backoff_s = float(opts.retry_backoff_s)
        self.validate_digests = bool(opts.validate_digests)
        self.fallback_on_failure = bool(opts.fallback_on_failure)
        self.max_query_failures = int(opts.max_query_failures)
        self.shed_policy = opts.shed_policy
        self._faults = opts.faults          # core.faults.FaultPlan | None
        self.fault_counters = {
            "dispatch_retries": 0, "hangs": 0, "digest_failures": 0,
            "quarantined": 0, "fallbacks": 0, "errors": 0,
            "flush_drops": 0, "shed": 0, "admission_failures": 0}

    # ------------------------------------------------------------------
    # submission / admission
    # ------------------------------------------------------------------
    def submit(self, query: Graph, *, options: MatchOptions | None = None,
               cand: list[np.ndarray] | None = None,
               order: np.ndarray | None = None,
               on_embeddings=None, **overrides) -> int:
        """Enqueue a query; returns its scheduler query id. Per-query
        knobs resolve through :class:`MatchOptions` with this
        scheduler's ``options`` as defaults (see the reference for each
        one). Raises :class:`QueueFull` when the bounded admission queue
        is at capacity."""
        opts = MatchOptions.resolve(
            options if options is not None else self.options, **overrides)
        if (len(self.queue) >= self.max_queue
                and self.shed_policy != "shed_lowest"):
            raise QueueFull(
                f"admission queue at capacity ({self.max_queue})")
        if query.n > N_PAD:
            raise ValueError(f"query too large for mask width: {query.n}")
        t_submit = time.perf_counter()
        qid = self._next_qid
        self._next_qid += 1
        cand_by_pos, order, _pos_of, nbr_pos = _prepare(
            query, self.data, cand, order)
        n = query.n
        cand_dense = np.zeros((N_PAD, self.data.n), bool)
        for d in range(n):
            cand_dense[d, cand_by_pos[d]] = True
        nbr_mask = np.zeros((N_PAD, N_PAD), bool)
        qnbr_bits = np.zeros(N_PAD, np.uint64)
        for d in range(n):
            bits = np.uint64(0)
            for p in nbr_pos[d]:
                nbr_mask[d, int(p)] = True
                bits |= bit_of(int(p))
            qnbr_bits[d] = bits
        learn = (self.use_pruning if opts.use_pruning is None
                 else opts.use_pruning)
        cand_packed = pack_bitmap(cand_dense)
        req = _Request(
            query_id=qid, n=n, order=np.asarray(order, np.int32),
            roots=np.asarray(cand_by_pos[0], np.int32),
            cand_bitmap=cand_packed, nbr_mask=nbr_mask,
            qnbr_bits=qnbr_bits, limit=opts.limit, learn=learn,
            max_rows=opts.max_recursions,
            time_budget_s=opts.time_budget_s,
            seed_patterns=opts.seed_patterns, keep_table=opts.keep_table,
            t_submit=t_submit, fingerprint=None,
            parallelism=max(1, int(opts.parallelism)),
            priority=int(opts.priority), on_embeddings=on_embeddings)
        if len(req.roots) == 0 or n == 1:
            self._finish_trivial(req)
        else:
            if self.pattern_cache is not None and learn:
                req.fingerprint = PatternCache.fingerprint(
                    n, cand_packed, nbr_mask)
            if len(self.queue) >= self.max_queue:
                # shed_lowest: the overall lowest-priority request —
                # queued or new, newest within a tie — finishes "shed"
                victim = min(range(len(self.queue)),
                             key=lambda i: (self.queue[i].priority, -i))
                if req.priority <= self.queue[victim].priority:
                    self._shed_request(req)
                    return qid
                shed_req = self.queue[victim]
                del self.queue[victim]
                self._shed_request(shed_req)
            self.queue.append(req)
        return qid

    def _shed_request(self, req: _Request) -> None:
        stats = EngineStats()
        stats.aborted = True
        stats.abort_reason = "shed"
        stats.table_stats = None
        stats.wall_time_s = time.perf_counter() - req.t_submit
        self.finished[req.query_id] = MatchResult([], stats)
        self._fresh_done.append(req.query_id)
        self.fault_counters["shed"] += 1

    def _finish_trivial(self, req: _Request) -> None:
        stats = EngineStats()
        stats.table_stats = None
        embeddings: list[np.ndarray] = []
        if req.n == 1 and len(req.roots) > 0:
            stats.rows_created = len(req.roots)
            for v0 in req.roots:
                emb = np.empty(1, np.int32)
                emb[req.order[0]] = v0
                embeddings.append(emb)
            if req.limit is not None and len(embeddings) >= req.limit:
                embeddings = embeddings[:req.limit]
                stats.aborted = True
                stats.abort_reason = "limit"
            stats.found = len(embeddings)
            stats.recursions = stats.rows_created
        stats.wall_time_s = time.perf_counter() - req.t_submit
        if embeddings:
            stats.ttfe_s = stats.wall_time_s
            if req.on_embeddings is not None:
                req.on_embeddings(np.stack(embeddings).astype(np.int32))
        self.finished[req.query_id] = MatchResult(embeddings, stats)
        if req.keep_table:
            self.tables[req.query_id] = (req.seed_patterns
                                         if req.seed_patterns is not None
                                         else empty_entries())
        self._fresh_done.append(req.query_id)

    def reserve_phi_floor(self, floor: int) -> None:
        """Raise the pool's embedding-id counter to at least ``floor``,
        so seeded μ > 0 patterns (written under another scheduler's φ
        numbering, e.g. a checkpoint) can never match a fresh id."""
        self.pool.id_counter = max(self.pool.id_counter, int(floor))

    def _pop_admission(self) -> _Request:
        """Highest priority first, FIFO within a tie."""
        best = max(range(len(self.queue)),
                   key=lambda i: (self.queue[i].priority, -i))
        req = self.queue[best]
        del self.queue[best]
        return req

    def _admit(self) -> None:
        loads: list[tuple] = []
        dev_clears: list[int] = []
        while self.queue:
            slot = self.pool.free_slot()
            if slot is None:
                break
            req = self._pop_admission()
            if self._faults is not None and self._faults.poke(
                    "admission", query_id=req.query_id) is not None:
                self.fault_counters["admission_failures"] += 1
                self._fail_request(req, "injected admission fault")
                continue
            learn = req.learn and self.pool.learning_enabled
            # Δ seed priority: explicit entries > template-cache warm
            # start (μ == 0 only) > empty store
            entries = req.seed_patterns
            warm = False
            if entries is None and req.learn \
                    and self.pattern_cache is not None:
                pend = self._pending_snaps.pop(req.fingerprint, None)
                if pend is not None:
                    snap_store, snap_hits = pend
                    self.pattern_cache.put(
                        req.fingerprint,
                        store_to_entries(snap_store, snap_hits))
                entries = self.pattern_cache.get(req.fingerprint)
                warm = entries is not None
            if entries is not None and len(entries["pos"]) > 0:
                store = entries_to_store(entries, self.pattern_capacity,
                                         self.device)
            else:
                store = self._empty_store
            loads.append((slot, req.cand_bitmap, req.nbr_mask, req.n,
                          store, learn))
            now = time.perf_counter()
            deadline = (None if req.time_budget_s is None
                        else now + req.time_budget_s)
            q = QueryState(slot, req.query_id, req.n, req.order,
                           req.qnbr_bits, self.w, limit=req.limit,
                           learn=learn, max_rows=req.max_rows,
                           deadline=deadline, keep_table=req.keep_table,
                           t_submit=req.t_submit,
                           parallelism=req.parallelism)
            q.fingerprint = req.fingerprint
            q.emb_sink = req.on_embeddings
            # the request stays with the query so a quarantine can
            # replay it on the degraded path
            q.request = req
            q.fail_count = req.fail_count
            q.force_single = req.host_only
            if req.prior_embeddings:
                # degraded-mode replay: carry the embeddings found
                # before demotion; the replay deduplicates against
                # ``emb_seen`` so re-enumeration cannot double-count
                q.embeddings.extend(req.prior_embeddings)
                q.emb_delivered = len(req.prior_embeddings)  # streamed
                q.stats.found = len(req.prior_embeddings)
                q.stats.ttfe_s = req.prior_ttfe
            if req.host_only:
                q.emb_seen = (req.emb_seen if req.emb_seen is not None
                              else set())
                q.stats.rows_created += req.prior_rows
                q.stats.fallback = True
            q.stats.table_stats = DeadEndStats(
                capacity=self.pattern_capacity)
            if warm:
                q.stats.cache_hit = True
                q.stats.warm_patterns = len(entries["pos"])
                self.warm_started += 1
                self.warm_patterns_seeded += len(entries["pos"])
            if req.keep_table:
                q.hit_counts = {}
                if entries is not None:
                    for p, v, h in zip(entries["pos"].tolist(),
                                       entries["v"].tolist(),
                                       entries["hits"].tolist()):
                        q.hit_counts[(int(p), int(v))] = int(h)
            q.stats.rows_created += len(req.roots)
            if (self._use_device and q.parallelism == 1
                    and not req.keep_table and not req.host_only):
                # device-resident stack path: roots trickle onto the
                # device stack as it has headroom (the cursor advances
                # by the digest's per-slot accept count)
                q.device = True
                q.pending_roots = req.roots
                q.root_cursor = 0
                q.dev_roots_inflight = False
                q.dev_wedge = 0
                q.dev_sig = None
                dev_clears.append(slot)
            else:
                self._admit_host_roots(q, req.roots)
            self.pool.attach(slot, q)
        self._flush_slot_loads(loads, dev_clears)

    def _flush_slot_loads(self, loads: list[tuple],
                          dev_clears: list[int]) -> None:
        """Install an admission burst's bank rows (in place): one
        batched write per lane instead of one per query."""
        if dev_clears:
            clear_slot_stacks(self.sb, dev_clears)
        if not loads:
            return
        if len(loads) == 1:
            slot, cb, nm, n, store, learn = loads[0]
            load_slot(self.qb, self.tb, slot, _i32(cb, self.device),
                      _i32(nm, self.device), n, store, learn)
            return
        # explicit per-lane stacking of the admitted stores
        store = PatternStore(*(torch.stack(lanes) for lanes in
                               zip(*[r[4] for r in loads])))
        load_slots(
            self.qb, self.tb,
            torch.tensor([r[0] for r in loads], device=self.device),
            _i32(np.stack([r[1] for r in loads]), self.device),
            _i32(np.stack([r[2] for r in loads]), self.device),
            torch.tensor([r[3] for r in loads], dtype=torch.int32,
                         device=self.device),
            store,
            torch.tensor([r[5] for r in loads], device=self.device))

    def _admit_host_roots(self, q: QueryState, all_roots: np.ndarray
                          ) -> None:
        """Seed host root segments: one per contiguous slice of the root
        range for each of the query's shards."""
        r = len(all_roots)
        bounds = np.linspace(0, r, q.parallelism + 1).astype(int)
        for shard in range(q.parallelism):
            lo, hi = int(bounds[shard]), int(bounds[shard + 1])
            if hi <= lo:
                continue
            roots = all_roots[lo:hi]
            k = hi - lo
            frontier = np.full((k, N_PAD), -1, np.int32)
            frontier[:, 0] = roots
            used = np.zeros((k, self.w), np.uint32)
            used[np.arange(k), roots // 32] = (
                np.uint32(1) << (roots.astype(np.uint32)
                                 % np.uint32(32)))
            phi = np.zeros((k, N_PAD + 1), np.int32)
            base = self.pool.alloc_ids(k)
            phi[:, 1] = np.arange(base, base + k)
            root_seg = q.new_segment(1, frontier, used, phi,
                                     np.full(k, -1, np.int32),
                                     np.zeros(k, np.int32),
                                     shard=shard)
            q.push(WorkItem(root_seg.seg_id, 0, k, "fresh", shard))

    # ------------------------------------------------------------------
    # streamed-embedding delivery / completion / cancellation
    # ------------------------------------------------------------------
    def _deliver(self, q: QueryState) -> None:
        """Push embeddings found since the last delivery to the query's
        stream sink (and stamp TTFE on the first batch)."""
        n = len(q.embeddings)
        if n == q.emb_delivered:
            return
        if q.stats.ttfe_s is None:
            q.stats.ttfe_s = time.perf_counter() - q.t_submit
        if q.emb_sink is not None:
            batch = np.stack(q.embeddings[q.emb_delivered:]).astype(
                np.int32)
            q.emb_sink(batch)
        q.emb_delivered = n

    def _finish(self, q: QueryState) -> None:
        t0 = time.perf_counter()
        f0 = self.t_flush_s
        self._deliver(q)
        q.materialize_hits()
        want_cache = (self.pattern_cache is not None and q.learn
                      and q.fingerprint is not None)
        if (q.keep_table or want_cache) and q.store_buf:
            # make patterns from the final resolutions visible in the
            # snapshot
            self._flush_stores(force=True)
        # the retiring query's last insert counters fold while it still
        # owns its slot
        self._materialize_flush_counters()
        q.status = "done"
        q.evict()
        q.stats.recursions = q.stats.rows_created
        q.stats.wall_time_s = time.perf_counter() - q.t_submit
        if q.parallelism > 1:
            q.stats.shard_rows = q.shard_rows.tolist()
            q.stats.shard_items = q.shard_items.tolist()
        self.total_prunes += q.stats.deadend_prunes
        self.total_rows_created += q.stats.rows_created
        self.total_steals += q.stats.steals
        ts = q.stats.table_stats
        if isinstance(ts, DeadEndStats):
            ts.hits = q.stats.deadend_prunes
        if q.keep_table:
            entries = store_to_entries(read_store_slot(self.tb, q.slot),
                                       q.hit_counts)
            if isinstance(ts, DeadEndStats):
                ts.occupancy = len(entries["pos"])
            self.tables[q.query_id] = entries
            if want_cache:
                self.pattern_cache.put(q.fingerprint, entries)
        elif want_cache:
            # defer: snapshot the slot store on the device; it becomes a
            # cache line only if the same template is admitted again
            snap = read_store_slot(self.tb, q.slot)
            hits = dict(q.hit_counts) if q.hit_counts is not None else None
            prev = self._pending_snaps.pop(q.fingerprint, None)
            if prev is not None:
                self.pattern_cache.put(q.fingerprint,
                                       store_to_entries(*prev))
            self._pending_snaps[q.fingerprint] = (snap, hits)
            while len(self._pending_snaps) > max(8, 2 * self.n_slots):
                old_fp, (old_snap, old_hits) = \
                    self._pending_snaps.popitem(last=False)
                self.pattern_cache.put(
                    old_fp, store_to_entries(old_snap, old_hits))
        self.finished[q.query_id] = MatchResult(q.embeddings, q.stats)
        self._fresh_done.append(q.query_id)
        if q.device and self.sb is not None:
            clear_slot_stack(self.sb, q.slot)
        self.pool.release(q.slot)
        self.t_retire_s += (time.perf_counter() - t0
                            - (self.t_flush_s - f0))

    def _abort(self, q: QueryState, reason: str) -> None:
        """Abort a query (budget, limit, cancel); partial embeddings are
        kept. Its rows still on the device are dropped at digest time."""
        q.stats.aborted = True
        q.stats.abort_reason = reason
        q.abort_reason = reason
        self._finish(q)

    def cancel(self, qid: int) -> bool:
        """Cancel a submitted query (queued: removed; resident: aborted
        with ``abort_reason == "cancelled"``). False if already done."""
        if qid in self.finished:
            return False
        for i, req in enumerate(self.queue):
            if req.query_id == qid:
                del self.queue[i]
                stats = EngineStats()
                stats.aborted = True
                stats.abort_reason = "cancelled"
                stats.table_stats = None
                stats.wall_time_s = time.perf_counter() - req.t_submit
                self.finished[qid] = MatchResult([], stats)
                self._fresh_done.append(qid)
                return True
        for q in self.pool.active_queries():
            if q.query_id == qid:
                self._abort(q, "cancelled")
                return True
        return False

    # ------------------------------------------------------------------
    # fault tolerance: retry, quarantine, degraded-mode replay
    # (DESIGN.md §8)
    # ------------------------------------------------------------------
    def _fail_request(self, req: _Request, msg: str) -> None:
        """Finish a request that failed before (or at) admission with
        ``status="error"``; embeddings carried from a prior incarnation
        are kept."""
        stats = EngineStats()
        stats.aborted = True
        stats.abort_reason = "error"
        stats.fault = msg
        stats.table_stats = None
        stats.found = len(req.prior_embeddings or ())
        stats.wall_time_s = time.perf_counter() - req.t_submit
        self.finished[req.query_id] = MatchResult(
            list(req.prior_embeddings or ()), stats)
        self._fresh_done.append(req.query_id)
        self.fault_counters["errors"] += 1

    def _run_dispatch(self, call, queries: list, stacks: bool):
        """Run one device dispatch with bounded retry and exponential
        backoff. Returns ``(result, hung, seconds)``; ``result is None``
        means the dispatch failed for good — the involved ``queries``
        were quarantined and the banks rebuilt (``stacks=True`` the
        frontier StackBank too). An injected hang runs the dispatch but
        flags its digest untrusted for the retire-side watchdog.

        An injected exception fires before the call, so its retry
        starts from untouched banks. A real ``torch.OutOfMemoryError``
        may strike after the call began updating the banks in place:
        a device-stack dispatch then fails for good at once (its
        queries replay on the degraded path), and a host megastep
        retries on a rebuilt Δ bank (sound: patterns only prune, and
        the host segments are not touched by the call). Nothing else is
        caught."""
        attempt = 0
        while True:
            hung = False
            try:
                if self._faults is not None:
                    spec = self._faults.poke("dispatch")
                    if spec is not None:
                        if spec.kind == "hang":
                            self.fault_counters["hangs"] += 1
                            hung = True
                        else:
                            raise FaultInjected(
                                "injected dispatch exception")
                t0 = time.perf_counter()
                res = call()
                return res, hung, time.perf_counter() - t0
            except DISPATCH_ERRORS as exc:
                attempt += 1
                torn = not isinstance(exc, FaultInjected)
                if attempt > self.dispatch_retries or (torn and stacks):
                    self._dispatch_failed(queries, exc, stacks)
                    return None, False, 0.0
                if torn:
                    self._invalidate_device_state(stacks=False)
                self.fault_counters["dispatch_retries"] += 1
                time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))

    def _dispatch_failed(self, queries: list, exc: BaseException,
                         stacks: bool) -> None:
        msg = (f"dispatch failed after {self.dispatch_retries + 1} "
               f"attempts: {exc}")
        self._watchdog_fire({q.slot: q for q in queries}, msg, stacks)

    def _invalidate_device_state(self, stacks: bool) -> None:
        """Rebuild the banks on ``self.device`` after a hang, a failed
        dispatch or a globally invalid digest. Sound: Δ patterns only
        prune, and every query whose frontier lived in the stack bank
        is quarantined by the caller."""
        self.tb = PatternStoreBank.empty(self.n_slots,
                                         self.pattern_capacity, self.device)
        self._flush_ctr_dev = None
        self._pending_snaps.clear()
        if stacks and self._use_device:
            self.sb = StackBank.empty(self.n_slots, self.stack_capacity,
                                      self.w, self.device)

    def _watchdog_fire(self, slot_map: dict, msg: str,
                       stacks: bool) -> None:
        """A hung, failed or untrusted dispatch retires cleanly instead
        of blocking all slots: rebuild the banks and quarantine every
        involved query. A rebuilt stack bank also drops the frontier of
        any device query the dispatch did not carry (one admitted while
        it was in flight), so those are quarantined too."""
        self._invalidate_device_state(stacks)
        involved = list(slot_map.values())
        if stacks:
            seen = {id(q) for q in involved}
            involved += [q for q in self._device_queries()
                         if id(q) not in seen]
        for q in involved:
            if q.active:
                self._quarantine(q, msg)

    def _quarantine(self, q: QueryState, reason: str) -> None:
        """resident → quarantined → replay on the degraded path, or —
        past the per-query failure budget (or with fallback disabled) —
        status "error" through the abort/eviction path."""
        self.fault_counters["quarantined"] += 1
        q.fail_count += 1
        req = q.request
        if (self.fallback_on_failure and req is not None
                and q.fail_count <= self.max_query_failures):
            self.fault_counters["fallbacks"] += 1
            self._demote_to_host(q, req)
        else:
            self.fault_counters["errors"] += 1
            q.stats.fault = reason
            self._abort(q, "error")

    def _demote_to_host(self, q: QueryState, req: _Request) -> None:
        """Tear the query down without publishing a result and re-enqueue
        its request on the host-scheduled path (``host_only``: host
        segments, one item per wave, same device). Embeddings found so
        far ride along and the replay deduplicates against them, so the
        final set is exact; neighbours are untouched."""
        seen = set()
        prior = []
        for e in q.embeddings:
            b = np.asarray(e, np.int32)
            key = b.tobytes()
            if key not in seen:
                seen.add(key)
                prior.append(b)
        req2 = dataclasses.replace(
            req, host_only=True, fail_count=q.fail_count,
            prior_embeddings=prior, emb_seen=seen,
            prior_rows=q.stats.rows_created, prior_ttfe=q.stats.ttfe_s,
            seed_patterns=None, on_embeddings=q.emb_sink)
        q.status = "quarantined"    # in-flight digests for this slot drop
        q.evict()
        if q.device and self.sb is not None:
            clear_slot_stack(self.sb, q.slot)
        self.pool.release(q.slot)
        # internal re-admission: past the max_queue bound (the query
        # already held a slot), ahead of its priority tie
        self.queue.appendleft(req2)

    def _validate_device_digest(self, dig: dict, n_emb: int,
                                embS: np.ndarray, embF: np.ndarray,
                                slot_map: dict) -> tuple[dict, bool]:
        """Check every invariant a sound digest must satisfy (DESIGN.md
        §8). Returns ``(bad, global_bad)``."""
        cap = self.stack_capacity
        v = self.data.n
        if n_emb < 0 or n_emb > self._emb_cap:
            return {}, True
        if n_emb and ((embS < 0) | (embS >= self.n_slots)).any():
            return {}, True
        bad: dict[int, str] = {}
        for slot, q in slot_map.items():
            if not q.active or not q.device:
                continue
            pend, live = int(dig["d_pending"][slot]), \
                int(dig["d_live"][slot])
            if not (0 <= pend <= live <= cap):
                bad[slot] = (f"stack occupancy out of bounds: "
                             f"pending={pend} live={live} capacity={cap}")
                continue
            neg = [k for k in ("d_accepted", "d_expanded", "d_rows",
                               "d_prunes", "d_inj", "d_stored")
                   if int(dig[k][slot]) < 0]
            if neg:
                bad[slot] = f"negative counter lane {neg[0]}"
                continue
            if int(dig["d_outsum"][slot]) != int(dig["d_childlive"][slot]):
                bad[slot] = (
                    "Lemma-4 outstanding-counter conservation violated: "
                    f"sum(outstanding)={int(dig['d_outsum'][slot])} != "
                    f"live children={int(dig['d_childlive'][slot])}")
                continue
            if n_emb:
                rows = embF[embS == slot][:, :q.n]
                if len(rows) and ((rows < 0) | (rows >= v)).any():
                    bad[slot] = "embedding row vertex out of range"
        return bad, False

    def _fold_embeddings(self, q: QueryState, rows: np.ndarray
                         ) -> np.ndarray:
        """Fold a ``[k, >= q.n]`` batch of found rows into the query:
        permute to query-vertex order, deduplicate against a replay's
        carried set, apply the limit, stream. Returns a bool mask of the
        rows that count as *reported* (duplicates included, so a
        successful row is never resolved as a failure; rows clipped by
        the limit stay unmarked — the caller aborts right after)."""
        k = len(rows)
        out = np.empty((k, q.n), np.int32)
        out[:, q.order[:q.n]] = rows[:, :q.n]
        if q.emb_seen is None:
            accept = np.ones(k, bool)
        else:
            accept = np.fromiter(
                (r.tobytes() not in q.emb_seen for r in out),
                bool, count=k)
        take = int(accept.sum())
        if q.limit is not None:
            take = min(take, q.limit - q.stats.found)
        report = np.ones(k, bool)
        idx = np.nonzero(accept)[0]
        report[idx[max(0, take):]] = False
        if take > 0:
            idx = idx[:take]
            if q.emb_seen is not None:
                for i in idx:
                    q.emb_seen.add(out[i].tobytes())
            q.embeddings.extend(out[idx])
            q.stats.found += take
            self._deliver(q)
        return report

    def _reset_learning_on_overflow(self) -> None:
        """Embedding-id overflow: clear all stores and pause learning
        (sound — only pruning is lost) until the pool drains."""
        if self.pool.id_overflow and self.pool.learning_enabled:
            self.tb = PatternStoreBank.empty(
                self.n_slots, self.pattern_capacity, self.device)
            self.pool.learning_enabled = False
            for qq in self.pool.active_queries():
                qq.learn = False

    def _check_budgets(self, now: float | None = None) -> None:
        for q in self.pool.active_queries():
            if q.deadline is not None:
                if now is None:
                    now = time.perf_counter()
                if now > q.deadline:
                    self._abort(q, "time")
                    continue
            if q.max_rows is not None and q.stats.rows_created > q.max_rows:
                self._abort(q, "rows")

    # ------------------------------------------------------------------
    # wave packing (host-segment queries)
    # ------------------------------------------------------------------
    def _pack_wave(self
                   ) -> list[tuple[QueryState, Segment, int, int, int]] | None:
        """Fill one wave with ready rows, round-robin across queries, all
        of one kind ("fresh" or "leftover"); see the reference for the
        occupancy-aware item cap. Returns [(query, segment, start, stop,
        shard)] or None when no work exists."""
        active = self.pool.active_queries()
        if not active:
            return None
        for q in active:
            if q.parallelism > 1:
                q.balance_shards()
        start = self._rr % len(active)
        order = active[start:] + active[:start]
        self._rr += 1
        if (self.megastep_depth <= 1
                or self._prune_ema > self.adaptive_prune_threshold):
            item_cap = 1
        else:
            item_cap = max(1, self.wave_size // len(active))
        kind = None
        picks: list[tuple[QueryState, Segment, int, int, int]] = []
        remaining = self.wave_size
        taken = dict.fromkeys(range(len(order)), 0)
        progress = True
        while remaining > 0 and progress:
            progress = False
            for qi, q in enumerate(order):
                if remaining == 0:
                    break
                if taken[qi] >= (1 if q.force_single else item_cap):
                    continue
                if kind is None:
                    kind = q.peek_kind()
                    if kind is None:
                        continue
                item = q.pop_ready(kind)
                if item is None:
                    taken[qi] = item_cap     # nothing of this kind now
                    continue
                take = min(remaining, item.stop - item.start)
                if take < item.stop - item.start:
                    q.push(WorkItem(item.seg_id, item.start + take,
                                    item.stop, item.kind, item.shard))
                picks.append((q, q.segments[item.seg_id], item.start,
                              item.start + take, item.shard))
                remaining -= take
                taken[qi] += 1
                progress = True
        if not picks:
            return None
        self._wave_kind = kind
        return picks

    def _build_wave(self, picks: list, kind: str):
        """Pack picked segment slices into fixed-shape wave arrays."""
        f_pad = self.wave_size
        fr = np.full((f_pad, N_PAD), -1, np.int32)
        us = np.zeros((f_pad, self.w), np.uint32)
        ph = np.zeros((f_pad, N_PAD + 1), np.int32)
        lo = np.zeros((f_pad, self.w), np.uint32)
        valid = np.zeros(f_pad, bool)
        slot_v = np.zeros(f_pad, np.int32)
        depth_v = np.zeros(f_pad, np.int32)
        metas: list[tuple] = []
        off = 0
        for q, seg, s, e, shard in picks:
            k = e - s
            fr[off:off + k] = seg.frontier[s:e]
            us[off:off + k] = seg.used[s:e]
            ph[off:off + k] = seg.phi[s:e]
            valid[off:off + k] = ~seg.resolved[s:e]
            slot_v[off:off + k] = q.slot
            depth_v[off:off + k] = seg.depth
            if kind == "leftover":
                lo[off:off + k] = seg.pending_leftover[s:e]
            metas.append((q, seg, s, e, off, k, shard))
            off += k
        self.waves += 1
        self.rows_packed += off
        occ = off / f_pad
        self.occ_sum += occ
        if self.pool.n_active == self.n_slots:
            self.waves_steady += 1
            self.occ_sum_steady += occ
        return fr, us, ph, lo, valid, slot_v, depth_v, metas

    def _note_prunes(self, prunes: int, rows: int) -> None:
        """Adaptive-depth EMA (decay 0.5) of the per-wave prune rate."""
        rate = prunes / max(1, prunes + rows)
        self._prune_ema = 0.5 * self._prune_ema + 0.5 * rate

    # ------------------------------------------------------------------
    # pattern store flushing (host-resolved Lemma-4 patterns)
    # ------------------------------------------------------------------
    def _pending_stores(self) -> list[tuple[QueryState, list]]:
        return [(q, q.store_buf) for q in self.pool.active_queries()
                if q.store_buf]

    @staticmethod
    def _drain_dedup(bufs: list, max_take: int | None) -> dict:
        """Drain up to ``max_take`` queued (key_pos, key_v, φ, μ, Γ)
        tuples, deduplicated by (slot, key), last write wins; consumed
        entries leave the buffers."""
        dedup: dict = {}
        i = 0
        for q, buf in bufs:
            take = (len(buf) if max_take is None
                    else min(len(buf), max_take - i))
            for key_pos, key_v, phi_id, mu_len, gamma in buf[:take]:
                dedup[(q.slot, key_pos, key_v)] = (phi_id, mu_len, gamma)
            i += take
            del buf[:take]
            if max_take is not None and i == max_take:
                break
        return dedup

    @staticmethod
    def _pack_store_batch(dedup: dict, n_pad: int):
        """Pack deduplicated entries into padded insert arrays (the
        validity lane marks padding)."""
        slots = np.zeros(n_pad, np.int32)
        kpos = np.zeros(n_pad, np.int32)
        kv = np.zeros(n_pad, np.int32)
        phis = np.zeros(n_pad, np.int32)
        mus = np.zeros(n_pad, np.int32)
        masks = np.zeros(n_pad, np.uint64)
        valid = np.zeros(n_pad, bool)
        for i, ((slot, key_pos, key_v), (phi_id, mu_len, gamma)) \
                in enumerate(dedup.items()):
            slots[i] = slot
            kpos[i] = key_pos
            kv[i] = key_v
            phis[i] = phi_id
            mus[i] = mu_len
            masks[i] = gamma
            valid[i] = True
        return slots, kpos, kv, phis, mus, words_from64(masks), valid

    def _store_args(self, batch) -> list[torch.Tensor]:
        return [_i32(a, self.device) for a in batch]

    def _fold_store_counters(self, counters, slot_map: dict | None) -> None:
        """Fold per-slot insert counters (4 lanes of [S]: stored,
        overwrites, evictions, dropped) into the scheduler totals and the
        owning queries' DeadEndStats."""
        lanes = dict(zip(("stored", "overwrites", "evictions", "dropped"),
                         (np.asarray(_np(c) if torch.is_tensor(c) else c,
                                     np.int64) for c in counters)))
        for k, v in lanes.items():
            self.store_counters[k] += int(v.sum())
        if slot_map is None:
            slot_map = {q.slot: q for q in self.pool.active_queries()}
        for slot, q in slot_map.items():
            ts = q.stats.table_stats
            if not isinstance(ts, DeadEndStats):
                continue
            ts.stores += int(lanes["stored"][slot])
            ts.overwrites += int(lanes["overwrites"][slot])
            ts.evictions += int(lanes["evictions"][slot])
            ts.dropped += int(lanes["dropped"][slot])

    def _flush_stores(self, force: bool = False) -> None:
        """Standalone batched Δ insert (single-step path and forced
        flushes); skipped when nothing is pending, and below
        ``store_flush_min`` unless forced."""
        bufs = self._pending_stores()
        if not bufs:
            return
        t0 = time.perf_counter()
        if not self.pool.learning_enabled:
            for q, buf in bufs:
                buf.clear()
            self.t_flush_s += time.perf_counter() - t0
            return
        total = sum(len(buf) for _, buf in bufs)
        if not force and total < self.store_flush_min:
            self.t_flush_s += time.perf_counter() - t0
            return
        dedup = self._drain_dedup(bufs, None)
        if self._faults is not None and dedup and self._faults.poke(
                "flush", n=len(dedup)) is not None:
            # injected flush failure: drop the batch — sound, patterns
            # only ever prune
            self.fault_counters["flush_drops"] += 1
            self.t_flush_s += time.perf_counter() - t0
            return
        n_pad = 16
        while n_pad < len(dedup):
            n_pad *= 2
        self.tb, counters = store_patterns_mq(
            self.tb, *self._store_args(self._pack_store_batch(dedup, n_pad)))
        self._flush_ctr_dev = (counters if self._flush_ctr_dev is None
                               else self._flush_ctr_dev.add(counters))
        self.t_flush_s += time.perf_counter() - t0

    def _materialize_flush_counters(self) -> None:
        """Fold the accumulated flush counters into stats (runs at every
        ownership change, so each slot has one owner in between)."""
        if self._flush_ctr_dev is None:
            return
        ctr, self._flush_ctr_dev = self._flush_ctr_dev, None
        self._fold_store_counters(ctr, None)

    def _drain_store_batch(self):
        """Drain up to ``store_pad`` host-queued pattern stores into the
        fixed-length arrays that ride the next megastep dispatch."""
        t0 = time.perf_counter()
        bufs = self._pending_stores()
        if not self.pool.learning_enabled:
            for q, buf in bufs:
                buf.clear()
            bufs = []
        dedup = self._drain_dedup(bufs, self.store_pad)
        if self._faults is not None and dedup and self._faults.poke(
                "flush", n=len(dedup)) is not None:
            # injected flush failure: drop the pattern batch (sound)
            self.fault_counters["flush_drops"] += 1
            dedup = {}
        out = self._pack_store_batch(dedup, self.store_pad)
        self.t_flush_s += time.perf_counter() - t0
        return out

    # ------------------------------------------------------------------
    # one scheduling step (double-buffered pipeline)
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """Admit, dispatch and fold one round of work; returns False
        when idle. The device-stack dispatch goes out before the host
        waves; each in-flight dispatch is folded after the next one was
        issued (double buffering), as in the reference."""
        self._check_budgets()
        t_a = time.perf_counter()
        self._admit()
        self.t_admit_s += time.perf_counter() - t_a
        if self.waves - self._last_aged_wave >= self.hit_decay_every:
            age_hits(self.tb)
            self._last_aged_wave = self.waves
        if self.megastep_depth <= 1:
            return self._step_single()
        # under a high prune EMA the device dispatch runs with t_max=1
        # and host waves take the single-step schedule — the paper's
        # tight store→lookup cadence
        ema_high = self._prune_ema > self.adaptive_prune_threshold
        retired_dev = False
        if self._inflight_dev is not None and self._device_tail():
            # tail regime: retire before dispatching, so a pool that just
            # completed skips the speculative trailing dispatch
            sync_dev, self._inflight_dev = self._inflight_dev, None
            self._retire_device(sync_dev)
            retired_dev = True
        t0 = time.perf_counter()
        rec_dev = self._dispatch_device(
            1 if ema_high else self.megastep_depth)
        self.t_dispatch_s += time.perf_counter() - t0
        prev_dev, self._inflight_dev = self._inflight_dev, rec_dev
        if ema_high:
            prev, self._inflight = self._inflight, None
            if prev is not None:
                self._retire_host(prev)
            progressed = self._step_single() or prev is not None
        else:
            t0 = time.perf_counter()
            picks = self._pack_wave()
            rec: _Inflight | None = None
            if picks is not None:
                if self._wave_kind == "fresh":
                    rec = self._dispatch_mega(picks)
                else:
                    rec = self._dispatch_leftover(picks)
            self.t_dispatch_s += time.perf_counter() - t0
            prev, self._inflight = self._inflight, rec
            if prev is not None:
                self._retire_host(prev)
            progressed = prev is not None or rec is not None
        if prev_dev is not None:
            self._retire_device(prev_dev)
        # a dispatch that failed for good leaves its queries' replays
        # queued: that is progress too
        return (progressed or retired_dev or prev_dev is not None
                or rec_dev is not None or bool(self.queue))

    def _retire_host(self, rec: _Inflight) -> None:
        if rec.kind == "mega":
            self._retire_mega(rec)
        else:
            self._retire_leftover(rec)

    # ------------------------------------------------------------------
    # device-resident stack dispatch / retire
    # ------------------------------------------------------------------
    def _device_queries(self) -> list[QueryState]:
        return [q for q in self.pool.active_queries() if q.device]

    def _device_tail(self) -> bool:
        """True when every device query's roots are already on device."""
        if self.queue:
            return False
        devq = self._device_queries()
        return bool(devq) and not any(
            len(q.pending_roots) > q.root_cursor for q in devq)

    def _dispatch_device(self, t_max: int) -> _InflightDev | None:
        """Feed pending roots into slots with headroom and run up to
        ``t_max`` device iterations from the per-slot stacks."""
        devq = self._device_queries()
        if not devq or self.sb is None:
            return None
        devq.sort(key=lambda q: q.slot)      # _group_rank wants slot order
        f = 2 * self.wave_size               # root intake, wider than a wave
        in_root = np.full(f, -1, np.int32)
        in_rid = np.zeros(f, np.int32)
        in_slot = np.zeros(f, np.int32)
        in_valid = np.zeros(f, bool)
        active = np.zeros(self.n_slots, bool)
        root_slots = []
        off = 0
        for q in devq:
            active[q.slot] = True
            if q.dev_roots_inflight:
                continue
            rest = len(q.pending_roots) - q.root_cursor
            if rest <= 0 or off >= f:
                continue
            k = min(rest, f - off)
            roots = q.pending_roots[q.root_cursor:q.root_cursor + k]
            base = self.pool.alloc_ids(k)
            in_root[off:off + k] = roots
            in_rid[off:off + k] = np.arange(base, base + k, dtype=np.int32)
            in_slot[off:off + k] = q.slot
            in_valid[off:off + k] = True
            q.dev_roots_inflight = True
            root_slots.append(q.slot)
            off += k
        if t_max > 1 and off == 0 and not any(
                len(q.pending_roots) > q.root_cursor for q in devq):
            t_max = 2 * t_max                # tail regime: deepen the call
        id_base = self.pool.alloc_ids(t_max * f * self._mega_kpr)
        self._reset_learning_on_overflow()
        dev = self.device
        args = [_i32(a, dev) for a in (in_root, in_rid, in_slot, in_valid,
                                       active)]
        res, hung, busy = self._run_dispatch(
            lambda: run_device_megastep(
                self.g, self.qb, self.tb, self.sb, *args, id_base,
                bool(self.pool.learning_enabled), t_max,
                kpr=self._mega_kpr, emb_cap=self._emb_cap,
                wave=self.wave_size, timing=self.timing),
            devq, stacks=True)
        if res is None:
            return None             # failed for good: queries quarantined
        self.n_dispatches += 1
        return _InflightDev(res, {q.slot: q for q in devq},
                            tuple(root_slots), t_max, busy_s=busy,
                            hung=hung)

    def _late(self, rec, t_read: float) -> str | None:
        """Per-dispatch watchdog: why the dispatch (its call plus its
        digest read) is untrusted, or None within ``dispatch_timeout_s``."""
        if (self.dispatch_timeout_s is None
                or rec.busy_s + t_read <= self.dispatch_timeout_s):
            return None
        return ("dispatch exceeded watchdog deadline "
                f"({self.dispatch_timeout_s:g}s)")

    def _retire_device(self, rec: _InflightDev) -> None:
        """Fold one digest: per-slot scalars into query stats, the
        embedding batch out to the owning queries, then completion /
        budget / wedge checks."""
        if rec.hung:
            # injected hang: neither the digest nor the banks it updated
            # are trusted — don't even read it
            self._watchdog_fire(rec.slot_map, "injected dispatch hang",
                                stacks=True)
            return
        res = rec.res
        t0 = time.perf_counter()
        # one device->host copy for every per-slot lane and the count
        lanes = _DEV_LANES + _PAT_LANES
        flat = _np(torch.cat([torch.stack([getattr(res, k) for k in lanes])
                              .reshape(-1), res.n_emb.reshape(1)]))
        s = self.n_slots
        dig = {k: flat[i * s:(i + 1) * s] for i, k in enumerate(lanes)}
        n_emb_raw = int(flat[-1])
        n_emb = max(0, min(n_emb_raw, self._emb_cap))
        embF = _np(res.emb_frontier[:n_emb])
        embS = _np(res.emb_slot[:n_emb])
        t1 = time.perf_counter()
        self.t_sync_s += t1 - t0
        late = self._late(rec, t1 - t0)
        if late is not None:
            self.fault_counters["hangs"] += 1
            self._watchdog_fire(rec.slot_map, late, stacks=True)
            return
        if self._faults is not None:
            slots = sorted(s for s, q in rec.slot_map.items()
                           if q.active and q.device)
            spec = (self._faults.poke("digest", slots=slots)
                    if slots else None)
            if spec is not None:
                corrupt_digest(dig, spec,
                               stack_capacity=self.stack_capacity,
                               slots=slots)
        if self.validate_digests:
            bad, global_bad = self._validate_device_digest(
                dig, n_emb_raw, embS, embF, rec.slot_map)
            if global_bad:
                self.fault_counters["digest_failures"] += 1
                self._watchdog_fire(rec.slot_map,
                                    "device digest globally invalid",
                                    stacks=True)
                return
            if bad:
                # quarantine each failing slot's query and zero its
                # lanes and rows, so the folds below stay clean —
                # neighbours' lanes and embedding rows are untouched
                for slot, why in bad.items():
                    self.fault_counters["digest_failures"] += 1
                    q = rec.slot_map[slot]
                    for k in _DEV_LANES:
                        dig[k][slot] = 0
                    if q.active:
                        self._quarantine(
                            q, f"digest validation failed: {why}")
                if len(embS):
                    keep = ~np.isin(embS, list(bad))
                    embF, embS = embF[keep], embS[keep]
                n_emb = len(embS)
        d_accepted = dig["d_accepted"]
        d_expanded = dig["d_expanded"]
        d_rows = dig["d_rows"]
        d_prunes = dig["d_prunes"]
        d_stored = dig["d_stored"]
        d_pending = dig["d_pending"]
        d_live = dig["d_live"]
        r0, f0 = self.t_retire_s, self.t_flush_s

        self._fold_store_counters([dig[k] for k in _PAT_LANES],
                                  rec.slot_map)
        self.slot_rows_expanded += d_expanded.astype(np.int64)
        self.slot_children_created += d_rows.astype(np.int64)
        expanded_total = int(d_expanded.sum())
        worked = bool(expanded_total or n_emb or d_accepted.sum())
        if worked:
            self.rows_packed += expanded_total
            occ = min(1.0, expanded_total / (self.wave_size * rec.t_max))
            self.occ_sum += occ
            self.waves += 1
            for q in rec.slot_map.values():
                if q.active:
                    q.stats.waves += 1
            if self.pool.n_active == self.n_slots:
                self.waves_steady += 1
                self.occ_sum_steady += occ

        emb_per_slot = (np.bincount(embS, minlength=self.n_slots)
                        if n_emb else np.zeros(self.n_slots, np.int64))

        for slot, q in rec.slot_map.items():
            if not q.active or not q.device:
                continue
            q.stats.rows_created += int(d_rows[slot])
            q.stats.deadend_prunes += int(d_prunes[slot])
            q.stats.injectivity_fails += int(dig["d_inj"][slot])
            q.stats.patterns_stored += int(d_stored[slot])
            if q.dev_roots_inflight and slot in rec.root_slots:
                q.root_cursor += int(d_accepted[slot])
                q.dev_roots_inflight = False

        if n_emb:
            for sl_v in np.unique(embS):
                q = rec.slot_map.get(int(sl_v))
                if q is None or not q.active:
                    continue
                self._fold_embeddings(q, embF[embS == sl_v])
                if q.limit is not None and q.stats.found >= q.limit:
                    self._abort(q, "limit")

        for slot, q in rec.slot_map.items():
            if not q.active or not q.device:
                continue
            if (q.max_rows is not None
                    and q.stats.rows_created > q.max_rows):
                self._abort(q, "rows")
                continue
            roots_done = (q.root_cursor >= len(q.pending_roots)
                          and not q.dev_roots_inflight)
            if roots_done and d_pending[slot] == 0 and d_live[slot] == 0:
                self._finish(q)
                continue
            # wedge detection: a full stack can throttle to a state where
            # iterations select rows but nothing allocates, resolves,
            # embeds or stores. After 3 observably identical digests,
            # export the stack back to host segments.
            moved = (int(d_accepted[slot]) or int(d_rows[slot])
                     or int(emb_per_slot[slot]) or int(d_stored[slot])
                     or int(d_prunes[slot]))
            sig = (int(d_pending[slot]), int(d_live[slot]))
            if moved or sig != q.dev_sig:
                q.dev_wedge = 0
            else:
                q.dev_wedge += 1
            q.dev_sig = sig
            if q.dev_wedge >= 3:
                self._export_device_query(q)
        if worked:
            self._note_prunes(int(d_prunes.sum()), int(d_rows.sum()))
        dt = time.perf_counter() - t1
        self.t_host_s += dt
        self.t_digest_s += max(0.0, dt - (self.t_retire_s - r0)
                               - (self.t_flush_s - f0))

    def _export_device_query(self, q: QueryState) -> None:
        """Wedge fallback: materialize one slot's device stack back into
        host segments (one 1-row segment per live entry, parent links
        preserved) and route the query through the host-segment path
        from here on — exact, as the entry lanes carry the same Lemma-4
        bookkeeping the host keeps."""
        slot = q.slot
        self.n_exported += 1
        if self._inflight_dev is not None:
            # the in-flight dispatch's mutations are already in the
            # stack (program order): ack its root batch now; its digest
            # for this query drops at retire time
            if (q.dev_roots_inflight
                    and slot in self._inflight_dev.root_slots):
                q.root_cursor += int(
                    self._inflight_dev.res.d_accepted[slot])
        q.dev_roots_inflight = False
        q.device = False
        sb = self.sb
        st = _np(sb.state[slot])
        frontier = _np(sb.frontier[slot])
        used = _words(sb.used[slot])
        phi = _np(sb.phi[slot])
        depth = _np(sb.depth[slot])
        cand = _words(sb.cand[slot])
        gamma64 = mask64(_np(sb.gamma[slot]))
        outstanding = _np(sb.outstanding[slot])
        reported = _np(sb.reported[slot])
        parent = _np(sb.parent[slot])
        live = np.nonzero(st != STK_FREE)[0]
        seg_of: dict[int, Segment] = {}
        for e in live.tolist():
            seg = q.new_segment(
                int(depth[e]), frontier[e:e + 1].copy(),
                used[e:e + 1].copy(), phi[e:e + 1].copy(),
                np.full(1, -1, np.int32), np.zeros(1, np.int32))
            seg_of[e] = seg
        res_items: list = []
        for e in live.tolist():
            seg = seg_of[e]
            p = int(parent[e])
            if p >= 0 and p in seg_of:
                seg.parent_seg[0] = seg_of[p].seg_id
                seg.parent_row[0] = 0
            state = int(st[e])
            if state == STK_FRESH:
                q.push(WorkItem(seg.seg_id, 0, 1, "fresh", 0))
                continue
            seg.expanded[0] = True
            seg.gamma[0] = gamma64[e]
            seg.outstanding[0] = int(outstanding[e])
            seg.reported[0] = bool(reported[e])
            if state == STK_LEFT:
                seg.pending_leftover[0] = cand[e]
                q.push(WorkItem(seg.seg_id, 0, 1, "leftover", 0))
            elif state == STK_RES:
                # already finalized on device (pattern stored there)
                seg.stored[0] = True
                res_items.append((seg.seg_id, 0, bool(reported[e]),
                                  gamma64[e]))
            elif state == STK_WAIT and int(outstanding[e]) == 0:
                res_items.append(q.finalize_row(seg, 0))
        q.resolve_rows(res_items)
        rest = q.pending_roots[q.root_cursor:]
        if len(rest):
            self._admit_host_roots(q, rest)
            q.stats.rows_created -= len(rest)   # counted at admission
        q.root_cursor = len(q.pending_roots)
        clear_slot_stack(self.sb, slot)
        if not q.segments:
            self._finish(q)

    # ------------------------------------------------------------------
    # host megastep dispatch / retire
    # ------------------------------------------------------------------
    def _dispatch_mega(self, picks: list) -> _Inflight:
        fr, us, ph, _lo, valid, slot_v, depth_v, metas = \
            self._build_wave(picks, "fresh")
        st = self._store_args(self._drain_store_batch())
        # worst-case id reservation: every ring position beyond the
        # input wave is a fresh row
        id_base = self.pool.alloc_ids(self._ring_capacity - self.wave_size)
        self._reset_learning_on_overflow()
        dev = self.device
        args = [_i32(a, dev) for a in (fr, us, ph, valid, slot_v, depth_v)]
        picked = list({q.slot: q for q, *_ in metas}.values())
        res, hung, busy = self._run_dispatch(
            lambda: run_megastep_mq(
                self.g, self.qb, self.tb, *args, *st, id_base,
                bool(self.pool.learning_enabled), kpr=self._mega_kpr,
                k_depth=self.megastep_depth, capacity=self._ring_capacity,
                emb_cap=self._emb_cap, timing=self.timing),
            picked, stacks=False)
        if res is None:
            return None             # failed for good: queries demoted
        self.n_dispatches += 1
        for q in picked:
            q.stats.waves += 1
        # slot map over ALL dispatch-time owners: the drained store batch
        # carries buffered patterns from every active query
        slot_map = {q.slot: q for q in self.pool.active_queries()}
        return _Inflight("mega", res, metas, slot_map, busy_s=busy,
                         hung=hung)

    def _retire_mega(self, rec: _Inflight) -> None:
        picked = {q.slot: q for q, *_ in rec.metas}
        if rec.hung:
            self._watchdog_fire(picked, "injected dispatch hang",
                                stacks=False)
            return
        res: MegaResult = rec.res
        t0 = time.perf_counter()
        head = int(res.head)
        tail = int(res.tail)
        # only ring rows [0, tail) carry anything: copy just those
        bufF = _np(res.buf_frontier[:tail])
        bufU = _words(res.buf_used[:tail])
        bufP = _np(res.buf_phi[:tail])
        slot_a = _np(res.buf_slot[:tail])
        depth_a = _np(res.buf_depth[:tail])
        parent_a = _np(res.buf_parent[:tail])
        valid_a = _np(res.buf_valid[:tail])
        rempty = _np(res.refined_empty[:tail])
        nchild = _np(res.n_children[:tail])
        nleft = _np(res.n_leftover[:tail])
        leftover = _words(res.leftover[:tail])
        pmask = mask64(_np(res.partial_mask[:tail]))
        nprun = _np(res.n_pruned[:tail])
        ninj = _np(res.n_inj[:tail])
        nembr = _np(res.n_emb_row[:tail])
        dstored = _np(res.dev_stored[:tail])
        pruned_v = _np(res.pruned_v[:tail])
        n_emb = int(res.n_emb)
        embF = _np(res.emb_frontier[:max(0, n_emb)])
        embS = _np(res.emb_slot[:max(0, n_emb)])
        t1 = time.perf_counter()
        self.t_sync_s += t1 - t0
        late = self._late(rec, t1 - t0)
        if late is not None:
            self.fault_counters["hangs"] += 1
            self._watchdog_fire(picked, late, stacks=False)
            return
        if self.validate_digests and not (
                0 <= head <= tail <= self._ring_capacity
                and 0 <= n_emb <= self._emb_cap):
            # the ring digest has no per-slot blame: an out-of-bounds
            # head/tail invalidates the whole dispatch
            self.fault_counters["digest_failures"] += 1
            self._watchdog_fire(
                picked, f"megastep digest globally invalid (head={head} "
                f"tail={tail} n_emb={n_emb})", stacks=False)
            return
        r0, f0 = self.t_retire_s, self.t_flush_s

        self._fold_store_counters(
            (res.pat_stored, res.pat_overwrites, res.pat_evictions,
             res.pat_dropped), rec.slot_map)

        f_in = self.wave_size
        slot_map = rec.slot_map
        involved: dict[int, QueryState] = {}
        sweeps: dict[int, list] = {}
        self.slot_rows_expanded += _np(res.slot_rows).astype(np.int64)
        self.slot_children_created += _np(res.slot_children).astype(
            np.int64)
        # shard of every ring row: input rows from their pick's work
        # item, in-loop rows inherit their parent's shard
        shard_of = np.zeros(tail, np.int32)

        # ---- 1) input-row bookkeeping (rows [0, f_in) of the ring) -----
        for q, seg, s, e, woff, k, shard in rec.metas:
            shard_of[woff:woff + k] = shard
            if not q.active:
                continue
            involved[q.query_id] = q
            sl = slice(woff, woff + k)
            rows = slice(s, e)
            seg.gamma[rows] |= pmask[sl]
            seg.pending_leftover[rows] = leftover[sl]
            seg.expanded[rows] = True
            seg.stored[rows] |= dstored[sl]
            seg.outstanding[rows] += nchild[sl]
            seg.reported[rows] |= nembr[sl] > 0
            q.stats.deadend_prunes += int(nprun[sl].sum())
            q.stats.injectivity_fails += int(ninj[sl].sum())
            q.stats.patterns_stored += int(dstored[sl].sum())
            if (nleft[sl] > 0).any():
                q.push(WorkItem(seg.seg_id, s, e, "leftover", shard))
            sweeps.setdefault(q.query_id, []).append(
                (seg, np.arange(s, e), rempty[sl]))

        # ---- Δ hit counters (pruned-child lanes, any ring row) ---------
        if any(q.hit_counts is not None for q in slot_map.values()):
            for sl_v, q in slot_map.items():
                if q.hit_counts is None:
                    continue
                rows = np.nonzero(slot_a[:tail] == sl_v)[0]
                if len(rows):
                    q.note_hits(depth_a[rows], pruned_v[rows])

        # ---- 2) embeddings found in-loop (+ limit aborts) --------------
        if n_emb:
            for sl_v in np.unique(embS):
                q = slot_map.get(int(sl_v))
                if q is None or not q.active:
                    continue
                self._fold_embeddings(q, embF[embS == sl_v])
                if q.limit is not None and q.stats.found >= q.limit:
                    self._abort(q, "limit")

        # ---- 3) rows created in-loop -> new segments -------------------
        if tail > f_in:
            # ring index -> (q-local segment id, row) for parent links;
            # parents always precede children in the ring
            seg_of = np.full(tail, -1, np.int64)
            row_of = np.full(tail, -1, np.int64)
            for q, seg, s, e, woff, k, shard in rec.metas:
                seg_of[woff:woff + k] = seg.seg_id
                row_of[woff:woff + k] = np.arange(s, e)
            new_idx = np.arange(f_in, tail)
            new_idx = new_idx[valid_a[f_in:tail]]
            if any(q.parallelism > 1 for q in slot_map.values()):
                for _ in range(self.megastep_depth):
                    shard_of[new_idx] = shard_of[parent_a[new_idx]]
            sl_arr = slot_a[new_idx]
            for sl_v in np.unique(sl_arr):
                q = slot_map.get(int(sl_v))
                qsel = new_idx[sl_arr == sl_v]
                if q is None or not q.active:
                    continue
                involved[q.query_id] = q
                qd = depth_a[qsel]
                qsh = shard_of[qsel]
                for d_v in np.unique(qd):          # ascending: parents
                    dsel = qsel[qd == d_v]         # precede children
                    dsh = qsh[qd == d_v]
                    for sh_v in np.unique(dsh):    # segments stay
                        sel = dsel[dsh == sh_v]    # shard-pure
                        exp_sel = sel[sel < head]
                        sel2 = np.concatenate([exp_sel, sel[sel >= head]])
                        r = len(sel2)
                        n_exp = len(exp_sel)
                        q.stats.rows_created += r
                        cseg = q.new_segment(
                            int(d_v), bufF[sel2], bufU[sel2], bufP[sel2],
                            seg_of[parent_a[sel2]].astype(np.int32),
                            row_of[parent_a[sel2]].astype(np.int32),
                            shard=int(sh_v))
                        cseg.expanded[:n_exp] = True
                        cseg.gamma[:n_exp] = pmask[exp_sel]
                        cseg.pending_leftover[:] = leftover[sel2]
                        cseg.outstanding[:] = nchild[sel2]
                        cseg.reported[:] = nembr[sel2] > 0
                        cseg.stored[:] = dstored[sel2]
                        q.stats.deadend_prunes += int(nprun[exp_sel].sum())
                        q.stats.injectivity_fails += int(ninj[exp_sel].sum())
                        q.stats.patterns_stored += int(dstored[sel2].sum())
                        seg_of[sel2] = cseg.seg_id
                        row_of[sel2] = np.arange(r)
                        if n_exp < r:
                            q.push(WorkItem(cseg.seg_id, n_exp, r, "fresh",
                                            int(sh_v)))
                        if n_exp and (nleft[exp_sel] > 0).any():
                            q.push(WorkItem(cseg.seg_id, 0, n_exp,
                                            "leftover", int(sh_v)))
                        sweeps.setdefault(q.query_id, []).append(
                            (cseg, np.arange(n_exp), rempty[exp_sel]))

        # ---- 4) Lemma-4 resolution sweep over every expanded row -------
        for qid, q in involved.items():
            if not q.active:
                continue
            items: list = []
            for seg, srows, remask in sweeps.get(qid, []):
                if seg.seg_id not in q.segments:
                    continue
                unres = ~seg.resolved[srows]
                for row in srows[remask & unres]:
                    # Lemma 1: Γ = N(u_d) ∩ dom(M̂)
                    gam = q.qnbr_bits[seg.depth] & below(seg.depth)
                    items.append((seg.seg_id, int(row), False, gam))
                cand = srows[~remask & unres]
                if len(cand):
                    done = cand[(seg.outstanding[cand] == 0)
                                & seg.expanded[cand]
                                & ~seg.pending_leftover[cand].any(axis=1)]
                    for row in done:
                        if seg.reported[row]:
                            items.append((seg.seg_id, int(row), True,
                                          np.uint64(0)))
                        else:
                            items.append(q.finalize_row(seg, int(row)))
            q.resolve_rows(items)
            if q.max_rows is not None and q.stats.rows_created > q.max_rows:
                self._abort(q, "rows")
            elif not q.segments:
                self._finish(q)
        self._note_prunes(int(nprun[:tail].sum()), max(0, tail - f_in))
        dt = time.perf_counter() - t1
        self.t_host_s += dt
        self.t_digest_s += max(0.0, dt - (self.t_retire_s - r0)
                               - (self.t_flush_s - f0))

    # ------------------------------------------------------------------
    # leftover extraction and single-step waves
    # ------------------------------------------------------------------
    def _extract_more(self, ph, slot_v, depth_v, lo) -> tuple:
        dev = self.device
        return extract_more_mq(self.tb, _i32(ph, dev), _i32(slot_v, dev),
                               _i32(depth_v, dev), _i32(lo, dev),
                               kpr=4 * self.kpr)

    def _leftover_digest(self, res: tuple) -> dict:
        child_valid = _np(res[1])
        return dict(
            refined_empty=np.zeros(self.wave_size, bool),
            n_children=child_valid.sum(axis=1).astype(np.int32),
            n_leftover=_np(res[3]), partial=mask64(_np(res[4])),
            child_v=_np(res[0]), child_valid=child_valid,
            leftover=_words(res[2]), n_pruned=_np(res[5]),
            n_inj=np.zeros(self.wave_size, np.int32),
            pruned_v=_np(res[6]))

    def _dispatch_leftover(self, picks: list) -> _Inflight:
        fr, us, ph, lo, valid, slot_v, depth_v, metas = \
            self._build_wave(picks, "leftover")
        res = self._extract_more(ph, slot_v, depth_v, lo)
        self.n_dispatches += 1
        slot_map = {q.slot: q for q, *_ in metas}
        for q in slot_map.values():
            q.stats.waves += 1
        return _Inflight("leftover", res, metas, slot_map,
                         fr=fr, us=us, ph=ph, depth_v=depth_v)

    def _retire_leftover(self, rec: _Inflight) -> None:
        t0 = time.perf_counter()
        digest = self._leftover_digest(rec.res)
        t1 = time.perf_counter()
        self.t_sync_s += t1 - t0
        r0, f0 = self.t_retire_s, self.t_flush_s
        self._process_wave("leftover", rec.metas, rec.fr, rec.us, rec.ph,
                           rec.depth_v, digest)
        dt = time.perf_counter() - t1
        self.t_host_s += dt
        self.t_digest_s += max(0.0, dt - (self.t_retire_s - r0)
                               - (self.t_flush_s - f0))

    def _step_single(self) -> bool:
        picks = self._pack_wave()
        if picks is None:
            return False
        kind = self._wave_kind
        t0 = time.perf_counter()
        fr, us, ph, lo, valid, slot_v, depth_v, metas = \
            self._build_wave(picks, kind)
        self._flush_stores()
        for q in {q.slot: q for q, *_ in metas}.values():
            q.stats.waves += 1
        dev = self.device
        if kind == "fresh":
            self.slot_rows_expanded += np.bincount(
                slot_v[valid], minlength=self.n_slots).astype(np.int64)
            res = expand_wave_mq(
                self.g, self.qb, self.tb, _i32(fr, dev), _i32(us, dev),
                _i32(ph, dev), _i32(valid, dev), _i32(slot_v, dev),
                _i32(depth_v, dev), kpr=self.kpr)
            self.timing["iterations"] += 1     # one Eq. 2 refine pass
            self.t_dispatch_s += time.perf_counter() - t0
            t1 = time.perf_counter()
            digest = dict(
                refined_empty=_np(res.refined_empty),
                n_children=_np(res.n_children),
                n_leftover=_np(res.n_leftover),
                partial=mask64(_np(res.partial_mask)),
                child_v=_np(res.child_v), child_valid=_np(res.child_valid),
                leftover=_words(res.leftover), n_pruned=_np(res.n_pruned),
                n_inj=_np(res.n_inj), pruned_v=_np(res.pruned_v))
        else:
            res = self._extract_more(ph, slot_v, depth_v, lo)
            self.t_dispatch_s += time.perf_counter() - t0
            t1 = time.perf_counter()
            digest = self._leftover_digest(res)
        self.n_dispatches += 1
        t2 = time.perf_counter()
        self.t_sync_s += t2 - t1
        r0, f0 = self.t_retire_s, self.t_flush_s
        self._process_wave(kind, metas, fr, us, ph, depth_v, digest)
        dt = time.perf_counter() - t2
        self.t_host_s += dt
        self.t_digest_s += max(0.0, dt - (self.t_retire_s - r0)
                               - (self.t_flush_s - f0))
        return True

    def _process_wave(self, kind: str, metas: list, fr, us, ph, depth_v,
                      digest: dict) -> None:
        """Host bookkeeping for one single-step wave digest: child
        assembly, embedding extraction, Lemma-4 resolution."""
        f_pad = self.wave_size
        refined_empty = digest["refined_empty"]
        n_children = digest["n_children"]
        n_leftover = digest["n_leftover"]
        partial = digest["partial"]
        child_v = digest["child_v"]
        child_valid = digest["child_valid"]
        leftover = digest["leftover"]
        n_pruned = digest["n_pruned"]
        n_inj = digest["n_inj"]
        pruned_v = digest["pruned_v"]

        # mask out rows of evicted queries and last-level rows — their
        # children are embeddings, not rows
        last_level = np.zeros(f_pad, bool)
        dead_rows = np.zeros(f_pad, bool)
        for q, seg, s, e, woff, k, shard in metas:
            if seg.depth + 1 == q.n:
                last_level[woff:woff + k] = True
            if not q.active:
                dead_rows[woff:woff + k] = True
        child_valid_eff = child_valid & ~last_level[:, None] \
            & ~dead_rows[:, None]

        cf = cu = cp = par = cvalid = None
        if child_valid_eff.any():
            id_base = self.pool.alloc_ids(int(child_valid_eff.sum()))
            dev = self.device
            cf, cu, cp, par, cvalid = assemble_children_mq(
                _i32(fr, dev), _i32(us, dev), _i32(ph, dev),
                torch.from_numpy(np.where(child_valid_eff, child_v, -1)
                                 ).to(dev),
                torch.from_numpy(child_valid_eff).to(dev),
                _i32(depth_v, dev), id_base)
            cf, cu, cp = _np(cf), _words(cu), _np(cp)
            par, cvalid = _np(par), _np(cvalid)
            self._reset_learning_on_overflow()

        wave_rows_created = 0
        for q, seg, s, e, woff, k, shard in metas:
            if not q.active:
                continue
            sl = slice(woff, woff + k)
            rows = slice(s, e)
            seg.gamma[rows] |= partial[sl]
            seg.pending_leftover[rows] = leftover[sl]
            q.stats.deadend_prunes += int(n_pruned[sl].sum())
            if q.hit_counts is not None:
                q.note_hits(depth_v[sl], pruned_v[sl])
            if kind == "fresh":
                seg.expanded[rows] = True
                q.stats.injectivity_fails += int(n_inj[sl].sum())

            # re-queue leftover before children (LIFO: children first)
            if (n_leftover[sl] > 0).any():
                q.push(WorkItem(seg.seg_id, s, e, "leftover", shard))

            if seg.depth + 1 == q.n:
                # complete embeddings (vectorized gather + permute)
                emb_rows, emb_cols = np.nonzero(child_valid[sl])
                if len(emb_rows):
                    mrows = seg.frontier[s + emb_rows].copy()
                    mrows[:, seg.depth] = \
                        child_v[woff + emb_rows, emb_cols]
                    report = self._fold_embeddings(q, mrows)
                    seg.reported[s + emb_rows[report]] = True
                if q.limit is not None and q.stats.found >= q.limit:
                    self._abort(q, "limit")
                    continue
            else:
                seg.outstanding[rows] += n_children[sl]
                # compact this item's children into a new segment
                if (n_children[sl] > 0).any():
                    lo_f, hi_f = woff * child_v.shape[1], \
                        (woff + k) * child_v.shape[1]
                    sel = np.nonzero(cvalid[lo_f:hi_f])[0] + lo_f
                    n_new = len(sel)
                    q.stats.rows_created += n_new
                    wave_rows_created += n_new
                    self.slot_children_created[q.slot] += n_new
                    cseg = q.new_segment(
                        seg.depth + 1, cf[sel], cu[sel], cp[sel],
                        np.full(n_new, seg.seg_id, np.int32),
                        (par[sel] - woff + s).astype(np.int32),
                        shard=shard)
                    q.push(WorkItem(cseg.seg_id, 0, n_new, "fresh", shard))

            # immediate resolutions
            items = []
            for i in range(k):
                row = s + i
                if seg.resolved[row]:
                    continue
                if refined_empty[woff + i]:
                    # Lemma 1: Γ = N(u_d) ∩ dom(M̂)
                    gam = q.qnbr_bits[seg.depth] & below(seg.depth)
                    items.append((seg.seg_id, row, False, gam))
                elif (seg.outstanding[row] == 0 and seg.expanded[row]
                      and not seg.pending_leftover[row].any()):
                    if seg.reported[row]:
                        items.append((seg.seg_id, row, True, np.uint64(0)))
                    else:
                        items.append(q.finalize_row(seg, row))
            q.resolve_rows(items)

            if q.max_rows is not None and q.stats.rows_created > q.max_rows:
                self._abort(q, "rows")
            elif not q.segments:
                self._finish(q)
        self._note_prunes(int(n_pruned.sum()), wave_rows_created)

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def poll(self) -> list[int]:
        """Query ids completed since the last poll."""
        done, self._fresh_done = self._fresh_done, []
        return done

    @property
    def idle(self) -> bool:
        return (not self.queue and self.pool.n_active == 0
                and self._inflight is None
                and self._inflight_dev is None)

    def run(self) -> dict[int, MatchResult]:
        """Drain all queued and in-flight queries."""
        while self.step():
            pass
        return self.finished

    def scheduler_stats(self) -> dict:
        """Aggregate wave statistics for SLO / occupancy reporting."""
        self._materialize_flush_counters()
        occupancy = _np(self.tb.valid.sum(dim=1)).astype(np.int64)
        active = self.pool.active_queries()
        prunes = self.total_prunes + sum(q.stats.deadend_prunes
                                         for q in active)
        rows = self.total_rows_created + sum(q.stats.rows_created
                                             for q in active)
        steals = self.total_steals + sum(q.stats.steals for q in active)
        return {
            "device": str(self.device),
            "steals": steals,
            "slot_rows_expanded": self.slot_rows_expanded.tolist(),
            "slot_children_created": self.slot_children_created.tolist(),
            "waves": self.waves,
            "dispatches": self.n_dispatches,
            "rows_packed": self.rows_packed,
            "wave_size": self.wave_size,
            "n_slots": self.n_slots,
            "megastep_depth": self.megastep_depth,
            "mean_occupancy": (self.occ_sum / self.waves
                               if self.waves else 0.0),
            "steady_occupancy": (self.occ_sum_steady / self.waves_steady
                                 if self.waves_steady else 0.0),
            "steady_waves": self.waves_steady,
            "peak_active": self.pool.peak_active,
            "queued": len(self.queue),
            "active": self.pool.n_active,
            "deadend_prunes": prunes,
            "rows_created": rows,
            "prune_rate": prunes / max(1, prunes + rows),
            "dispatch_time_s": self.t_dispatch_s,
            "device_sync_time_s": self.t_sync_s,
            "host_time_s": self.t_host_s,
            "host_admission_time_s": self.t_admit_s,
            "host_digest_time_s": self.t_digest_s,
            "host_retirement_time_s": self.t_retire_s,
            "host_flush_time_s": self.t_flush_s,
            "loop_iterations": self.timing["iterations"],
            "loop_readbacks": self.timing["readbacks"],
            "loop_readback_time_s": self.timing["readback_s"],
            "wedge_exports": self.n_exported,
            "device_stacks": self._use_device,
            "adjacency_variant": self.adjacency_variant,
            "adjacency_bytes": self.adjacency_bytes,
            "chunk_words": self.chunk_words,
            "pattern_capacity": self.pattern_capacity,
            "store_stored": self.store_counters["stored"],
            "store_overwrites": self.store_counters["overwrites"],
            "store_evictions": self.store_counters["evictions"],
            "store_dropped": self.store_counters["dropped"],
            "store_occupancy": occupancy.tolist(),
            "store_load_factor": float(
                occupancy.max() / self.pattern_capacity
                if self.n_slots else 0.0),
            "warm_started": self.warm_started,
            "warm_patterns_seeded": self.warm_patterns_seeded,
            # fault-tolerance counters (DESIGN.md §8)
            "faults": dict(self.fault_counters),
            "tuning": dict(self.tuning_record),
            "pattern_cache": (self.pattern_cache.report()
                              if self.pattern_cache is not None else None),
        }


class WaveEngine:
    """Single-query blocking facade over the request/handle API (one
    slot): ``match`` submits through a one-slot
    :class:`repro_torch.api.MatchSession` with ``keep_table=True`` and
    blocks on the handle.

    Usage::

        eng = WaveEngine(data_graph, device="cuda")
        res = eng.match(query_graph, limit=1000)
    """

    def __init__(self, data: Graph, *, options: MatchOptions | None = None,
                 device="cuda", **knobs):
        from ..api.session import MatchSession   # deferred: layering
        knobs["n_slots"] = 1                     # the single-query facade
        self._session = MatchSession(
            data, options=MatchOptions.resolve(options, **knobs),
            device=device)
        self.scheduler = self._session.scheduler

    def match(self, query: Graph, *, options: MatchOptions | None = None,
              cand: list[np.ndarray] | None = None,
              order: np.ndarray | None = None,
              **overrides) -> MatchResult:
        """Blocking single-query match; knobs resolve through
        :class:`repro_torch.api.MatchOptions`."""
        h = self._session.submit(query, options=options, cand=cand,
                                 order=order, keep_table=True,
                                 **overrides)
        qr = h.result()
        self._entries = self.scheduler.tables.pop(h.query_id, None)
        return MatchResult(qr.embeddings, qr.stats)


def match_vectorized(query: Graph, data: Graph, device="cuda",
                     **knobs) -> MatchResult:
    """One-shot convenience wrapper around :class:`WaveEngine`: every
    per-query and per-engine knob is a :class:`MatchOptions` field."""
    opts = MatchOptions.resolve(None, **knobs)
    return WaveEngine(data, options=opts, device=device).match(
        query, options=opts)
