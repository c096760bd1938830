"""Per-query search state for the shared-wave scheduler.

A *segment* is a fixed-shape batch of partial embeddings of one query,
all at one depth. Each concurrent query owns a DFS stack of
:class:`WorkItem` slices over its segments plus the resolution
bookkeeping that implements the paper's Lemma-4 mask aggregation across
waves (DESIGN.md §2): a row resolves when its subtree is exhausted, its
Γ* terms (empty-candidate, injectivity, dead-end, child masks) are
combined, and the resulting dead-end pattern is queued for the batched
device scatter.

:class:`SegmentPool` maps bank slots to live :class:`QueryState` objects
and owns the shared embedding-id counter — the scheduler in
``vectorized.py`` packs waves from whichever queries have ready segments.

Shard-as-segments (DESIGN.md §3): a query submitted with
``parallelism = k`` seeds *k* root segments, one per contiguous slice of
its root-candidate range, and keeps one DFS stack per shard. All shards
live in one bank slot, draw φ ids from the shared pool counter, and
write one slot-private dead-end table — so every pattern (μ > 0
included) learned by one shard prunes every other shard with no
exchange step. An idle shard steals by splitting the largest pending
work-item range of the most loaded shard (``balance_shards``);
per-shard rows/items/steal counters feed the serving reports.

Learning happens *across* waves and across queries' interleavings:
patterns extracted from failures in earlier-expanded subtrees prune later
waves. Matching is exact for any schedule because stored patterns are
true dead-ends.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..patterns.store import mask64, words_from64  # noqa: F401 (re-export)
from .backtrack import SearchStats

_ID_LIMIT = 2**31 - 2**22


def bit_of(p) -> np.uint64:
    return np.uint64(1) << np.uint64(p)


def below(d: int) -> np.uint64:
    return (np.uint64(1) << np.uint64(d)) - np.uint64(1) if d < 64 \
        else np.uint64(0xFFFFFFFFFFFFFFFF)


@dataclasses.dataclass
class Segment:
    seg_id: int
    depth: int                      # mapped positions per row
    frontier: np.ndarray            # int32 [R, N_PAD]
    used: np.ndarray                # uint32 [R, W]
    phi: np.ndarray                 # int32 [R, N_PAD + 1]
    parent_seg: np.ndarray          # int32 [R] (-1 for roots)
    parent_row: np.ndarray          # int32 [R]
    shard: int = 0                  # owning shard (parallelism > 1)
    # resolution state
    outstanding: np.ndarray | None = None   # int64 [R]
    gamma: np.ndarray | None = None         # uint64 [R] accumulated Γ*
    reported: np.ndarray | None = None      # bool [R]
    expanded: np.ndarray | None = None      # bool [R] first pass done
    pending_leftover: np.ndarray | None = None  # uint32 [R, W]
    resolved: np.ndarray | None = None      # bool [R]
    stored: np.ndarray | None = None        # bool [R] pattern already in Δ
    n_unresolved: int = 0

    def init_state(self, w: int) -> None:
        r = len(self.frontier)
        self.outstanding = np.zeros(r, np.int64)
        self.gamma = np.zeros(r, np.uint64)
        self.reported = np.zeros(r, bool)
        self.expanded = np.zeros(r, bool)
        self.pending_leftover = np.zeros((r, w), np.uint32)
        self.resolved = np.zeros(r, bool)
        # True for rows whose Lemma-1 pattern the megastep already
        # scattered into the device table in-loop — the host resolution
        # must not queue a duplicate store for them.
        self.stored = np.zeros(r, bool)
        self.n_unresolved = r


@dataclasses.dataclass
class EngineStats(SearchStats):
    waves: int = 0
    rows_created: int = 0
    patterns_stored: int = 0
    # shard-as-segments accounting (parallelism > 1, DESIGN.md §3)
    steals: int = 0
    shard_rows: list | None = None   # rows created per shard
    shard_items: list | None = None  # work items dispatched per shard
    # cross-query template cache (patterns.cache, DESIGN.md §6)
    cache_hit: bool = False          # Δ was warm-started from the cache
    warm_patterns: int = 0           # entries seeded at admission
    # fault tolerance (DESIGN.md §8)
    fault: str | None = None         # what failed (status == "error")
    fallback: bool = False           # completed on the degraded path


@dataclasses.dataclass
class WorkItem:
    """A ready slice of one segment: rows [start, stop) awaiting a fresh
    expansion or a leftover extraction pass. ``shard`` routes the item to
    one of the query's per-shard DFS stacks (always 0 for
    ``parallelism == 1``); stolen ranges carry the thief's shard id."""
    seg_id: int
    start: int
    stop: int
    kind: str                       # "fresh" | "leftover"
    shard: int = 0


class QueryState:
    """One concurrent query: DFS stack, segments, Lemma-4 resolution."""

    def __init__(self, slot: int, query_id: int, n: int, order: np.ndarray,
                 qnbr_bits: np.ndarray, w: int, *, limit: int | None,
                 learn: bool, max_rows: int | None,
                 deadline: float | None, keep_table: bool,
                 t_submit: float, parallelism: int = 1):
        self.slot = slot
        self.query_id = query_id
        self.n = n
        self.order = order
        self.qnbr_bits = qnbr_bits      # uint64 [N_PAD] query-adjacency bits
        self.w = w
        self.limit = limit
        self.learn = learn
        self.max_rows = max_rows
        self.deadline = deadline        # absolute perf_counter deadline
        self.keep_table = keep_table
        self.t_submit = t_submit
        self.parallelism = max(1, int(parallelism))
        self.stats = EngineStats()
        self.embeddings: list[np.ndarray] = []
        self.segments: dict[int, Segment] = {}
        # one DFS stack per shard (shard-as-segments, DESIGN.md §3)
        self.stacks: list[list[WorkItem]] = [
            [] for _ in range(self.parallelism)]
        self._shard_rr = 0
        self.shard_rows = np.zeros(self.parallelism, np.int64)
        self.shard_items = np.zeros(self.parallelism, np.int64)
        # Δ hit counters per (order position, vertex) key, accumulated
        # from the digests' pruned-child lanes into a sparse dict (the
        # old dense [N_PAD, V] array scaled with the data graph); drives
        # the deterministic cross-host pattern exchange and survives
        # device-side eviction/aging (allocated by the scheduler when
        # the table is exported).
        self.hit_counts: dict[tuple[int, int], int] | None = None
        # packed (depth << 32 | v) int64 hit keys buffered per digest;
        # folded into hit_counts by materialize_hits() at export time so
        # the per-wave hot path never touches the Python dict
        self._hit_buf: list[np.ndarray] = []
        # canonical template fingerprint (patterns.cache) — set at
        # admission so retirement can snapshot under the same key
        self.fingerprint: bytes | None = None
        # streamed-embedding delivery (DESIGN.md §4): the scheduler
        # pushes each newly found batch to ``emb_sink`` as the emitting
        # wave's digest is processed — not at retirement —
        # ``emb_delivered`` is the cursor into ``self.embeddings``.
        self.emb_sink = None
        self.emb_delivered = 0
        self.store_buf: list[tuple[int, int, int, int, np.uint64]] = []
        # "running" | "done" | "quarantined" (torn down for fallback
        # re-admission, no result published — DESIGN.md §8). Only
        # "running" is ``active``; in-flight digests for any other
        # status drop at retire time.
        self.status = "running"
        self.abort_reason: str | None = None  # "limit"|"rows"|"time"|...
        self._next_seg = 0
        # -- device-resident stack path (set by the scheduler at
        # admission when the query runs with no host segments) ----------
        self.device = False
        self.pending_roots: np.ndarray | None = None
        self.root_cursor = 0
        self.dev_roots_inflight = False
        self.dev_wedge = 0
        self.dev_sig = None
        # -- fault tolerance (DESIGN.md §8) -----------------------------
        self.request = None             # originating _Request (replay)
        self.fail_count = 0             # quarantines across incarnations
        self.force_single = False       # fallback: one item per wave
        self.emb_seen: set | None = None  # replay dedup (tobytes keys)

    # -- segment / stack management ------------------------------------
    def new_segment(self, depth: int, frontier: np.ndarray,
                    used: np.ndarray, phi: np.ndarray,
                    parent_seg: np.ndarray, parent_row: np.ndarray,
                    shard: int = 0) -> Segment:
        seg = Segment(self._next_seg, depth, frontier, used, phi,
                      parent_seg, parent_row, shard)
        seg.init_state(self.w)
        self.segments[self._next_seg] = seg
        self._next_seg += 1
        self.shard_rows[shard] += len(frontier)
        return seg

    def push(self, item: WorkItem) -> None:
        self.stacks[item.shard].append(item)

    def _live_top(self, shard: int) -> WorkItem | None:
        """Top live work item of one shard stack (discarding stale ones)."""
        st = self.stacks[shard]
        while st:
            item = st[-1]
            if item.seg_id not in self.segments:
                st.pop()
                continue
            return item
        return None

    def pop_ready(self, kind: str | None = None) -> WorkItem | None:
        """Pop a live work item, round-robin across shard stacks. With
        ``kind`` set, only an item of that kind is taken (the wave's
        picks all share one device program)."""
        for off in range(self.parallelism):
            shard = (self._shard_rr + off) % self.parallelism
            item = self._live_top(shard)
            if item is not None and (kind is None or item.kind == kind):
                self.stacks[shard].pop()
                self._shard_rr = (shard + 1) % self.parallelism
                self.shard_items[shard] += 1
                return item
        return None

    def peek_kind(self) -> str | None:
        """Kind of the next item pop_ready would take (round-robin)."""
        for off in range(self.parallelism):
            item = self._live_top((self._shard_rr + off) % self.parallelism)
            if item is not None:
                return item.kind
        return None

    def balance_shards(self) -> int:
        """Work stealing on work-item ranges (DESIGN.md §3): every idle
        shard splits the largest pending range of the most loaded shard
        and takes the upper half. Sound for any split because items are
        just row ranges of shared segments — the thief's children simply
        carry its shard id. Returns the number of steals."""
        if self.parallelism <= 1:
            return 0
        loads = [sum(it.stop - it.start for it in st
                     if it.seg_id in self.segments)
                 for st in self.stacks]
        steals = 0
        for shard in range(self.parallelism):
            if self._live_top(shard) is not None:
                continue
            donor = int(np.argmax(loads))
            if donor == shard or loads[donor] <= 1:
                continue
            best_i, best_len = -1, 1
            for i, it in enumerate(self.stacks[donor]):
                if (it.seg_id in self.segments
                        and it.stop - it.start > best_len):
                    best_i, best_len = i, it.stop - it.start
            if best_i < 0:
                continue
            it = self.stacks[donor][best_i]
            mid = (it.start + it.stop) // 2
            self.stacks[donor][best_i] = WorkItem(
                it.seg_id, it.start, mid, it.kind, it.shard)
            self.stacks[shard].append(WorkItem(
                it.seg_id, mid, it.stop, it.kind, shard))
            loads[donor] -= it.stop - mid
            loads[shard] += it.stop - mid
            steals += 1
        self.stats.steals += steals
        return steals

    def note_hits(self, depth, pruned_v) -> None:
        """Accumulate Δ hit counters from a digest's pruned-child lane
        (``pruned_v`` int32 [..., KPR], -1 padding; a prune at row depth
        d on vertex v is one hit on table key (d, v))."""
        if self.hit_counts is None:
            return
        pv = np.asarray(pruned_v)
        dd = np.broadcast_to(np.asarray(depth)[..., None], pv.shape)
        sel = pv >= 0
        if sel.any():
            # buffer packed int64 keys; the dict fold happens once in
            # materialize_hits(), not on every digest
            self._hit_buf.append(
                (dd[sel].astype(np.int64) << np.int64(32)) | pv[sel])

    def materialize_hits(self) -> None:
        """Fold every buffered ``note_hits`` batch into ``hit_counts``
        with a single ``np.unique``/``bincount`` pass (the old per-key
        Python loop walked each digest separately)."""
        if self.hit_counts is None or not self._hit_buf:
            return
        buf = self._hit_buf
        self._hit_buf = []
        if self.hit_counts:
            old = np.fromiter(
                ((np.int64(d) << np.int64(32)) | np.int64(v)
                 for d, v in self.hit_counts), np.int64,
                count=len(self.hit_counts))
            weights = np.concatenate(
                [np.fromiter(self.hit_counts.values(), np.float64,
                             count=len(self.hit_counts))]
                + [np.ones(len(b)) for b in buf])
            flat = np.concatenate([old] + buf)
        else:
            flat = np.concatenate(buf)
            weights = np.ones(len(flat))
        uniq, inv = np.unique(flat, return_inverse=True)
        counts = np.bincount(inv, weights=weights).astype(np.int64)
        self.hit_counts = {
            (int(f >> 32), int(f & 0xFFFFFFFF)): int(c)
            for f, c in zip(uniq.tolist(), counts.tolist())}

    def evict(self) -> None:
        """Drop all in-flight work (abort / completion)."""
        self.segments.clear()
        for st in self.stacks:
            st.clear()
        self.store_buf.clear()

    # -- Lemma-4 resolution bookkeeping --------------------------------
    def queue_store(self, seg: Segment, row: int, gamma: np.uint64) -> None:
        """Record the dead-end pattern of a resolved-dead row.

        ``stats.patterns_stored`` counts at queue time (patterns
        *learned*): the actual device scatter is batched across waves
        and fused into the megastep dispatch, so flush time no longer
        maps 1:1 to a wave. Rows the megastep already stored in-loop
        (``seg.stored``) are skipped — their pattern is in Δ.
        """
        if not self.learn or self.stats.aborted:
            return
        if seg.stored[row]:
            return
        d = seg.depth
        if d == 0:
            return
        key_pos = d - 1
        key_v = int(seg.frontier[row, key_pos])
        below_mask = gamma & below(key_pos)
        if below_mask:
            mu_len = int(below_mask).bit_length()   # highest set bit + 1
        else:
            mu_len = 0
        phi_id = int(seg.phi[row, mu_len])
        self.store_buf.append((key_pos, key_v, phi_id, mu_len, gamma))
        self.stats.patterns_stored += 1

    def has_leftover(self, seg: Segment, row: int) -> bool:
        return bool(seg.pending_leftover[row].any())

    def finalize_row(self, seg: Segment, row: int
                     ) -> tuple[int, int, bool, np.uint64]:
        """All children of this row are resolved: Lemma 4 conversion."""
        if seg.reported[row]:
            return (seg.seg_id, row, True, np.uint64(0))
        d = seg.depth
        gamma = seg.gamma[row]
        if gamma & bit_of(d):
            gamma = (gamma | self.qnbr_bits[d]) & below(d)
        return (seg.seg_id, row, False, gamma)

    def resolve_rows(self, items: list[tuple[int, int, bool, np.uint64]]
                     ) -> None:
        """Worklist of (seg_id, row, reported, gamma) resolutions,
        propagating up through parent segments."""
        while items:
            sid, row, reported, gamma = items.pop()
            seg = self.segments.get(sid)
            if seg is None or seg.resolved[row]:
                continue
            seg.resolved[row] = True
            seg.n_unresolved -= 1
            if not reported:
                self.queue_store(seg, row, gamma)
            ps, pr = int(seg.parent_seg[row]), int(seg.parent_row[row])
            if ps >= 0:
                pseg = self.segments[ps]
                if reported:
                    pseg.reported[pr] = True
                else:
                    pseg.gamma[pr] |= gamma
                pseg.outstanding[pr] -= 1
                if (pseg.outstanding[pr] == 0 and pseg.expanded[pr]
                        and not self.has_leftover(pseg, pr)):
                    items.append(self.finalize_row(pseg, pr))
            if seg.n_unresolved == 0:
                del self.segments[sid]

    @property
    def active(self) -> bool:
        return self.status == "running"


class SegmentPool:
    """Slot table of live queries plus the shared embedding-id counter."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.slots: list[QueryState | None] = [None] * n_slots
        self.id_counter = 1
        self.learning_enabled = True
        self.peak_active = 0

    def free_slot(self) -> int | None:
        for i, q in enumerate(self.slots):
            if q is None:
                return i
        return None

    def attach(self, slot: int, q: QueryState) -> None:
        assert self.slots[slot] is None
        self.slots[slot] = q
        self.peak_active = max(self.peak_active, self.n_active)

    def release(self, slot: int) -> None:
        self.slots[slot] = None
        if self.n_active == 0 and not self.learning_enabled:
            # id-space overflow recovery: once the pool drains, no live
            # phi value can collide with fresh ids, so learning restarts.
            self.id_counter = 1
            self.learning_enabled = True

    @property
    def n_active(self) -> int:
        return sum(q is not None for q in self.slots)

    def active_queries(self) -> list[QueryState]:
        return [q for q in self.slots if q is not None and q.active]

    def alloc_ids(self, n: int) -> int:
        """Reserve ``n`` fresh embedding ids; returns the base id. On
        overflow, learning pauses (tables are cleared by the scheduler)
        until the pool drains — matching stays exact throughout."""
        base = self.id_counter
        self.id_counter += n
        return base

    @property
    def id_overflow(self) -> bool:
        return self.id_counter > _ID_LIMIT
