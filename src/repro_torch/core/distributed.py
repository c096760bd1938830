"""Distributed subgraph matching: shard-as-segments on the shared-wave
scheduler, with sound full-Δ sharing, work stealing, and elastic
checkpoint/restore (DESIGN.md §3).

Twin of ``repro/core/distributed.py``, name for name. The root-candidate
space of one query is range-partitioned into shards, each a *root
segment* of one resident scheduler query (``parallelism = k``), so every
shard rides the port's wave scheduler on ``device``; all shards draw φ
ids from the scheduler's single pool and write one slot-private Δ
store, so every pattern (μ > 0 included) learned by one shard prunes the
others. An idle shard steals by splitting the largest pending work-item
range of the most loaded shard. Progress is checkpointable at segment
granularity — unresolved root rows, found embeddings, and the learned Δ
as a compact *entries* snapshot — in a compressed ``state.npz`` whose
version (:data:`CHECKPOINT_VERSION`), keys and dtypes are the
reference's, so a checkpoint written by either package restores in the
other. Restore may change the shard count and the pattern-store
capacity, and keeps the learned Δ. :func:`select_exchange_patterns`
picks the capped, hit-ranked pattern set that cross-host replication
would ship.

``share_patterns=False`` keeps the pre-unification ablation: each shard
runs as its *own* scheduler query in its own slot with a private store
and no sharing at all.

Shards execute as segments of one device-shared wave on one card; the
seeding, stealing and checkpoint logic is what a multi-host launcher
would drive.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from ..api.options import MatchOptions
from ..patterns.store import ENTRY_KEYS, select_entries
from .backtrack import MatchResult, _prepare
from .graph import Graph
from .segments import EngineStats
from .vectorized import WaveScheduler

CHECKPOINT_VERSION = 3
# legacy v2 dense-table npz keys (one-release read compatibility)
_V2_TABLE_KEYS = ("phi", "mu", "mask", "valid")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed structural validation (truncated archive,
    missing field, wrong shape/version). Raised by
    :meth:`DistributedMatcher.load_state` *before* any matcher state is
    mutated, naming the offending field — never a raw numpy traceback."""


def select_exchange_patterns(entries: dict, top_k: int,
                             transferable_only: bool = True) -> dict:
    """Deterministic top-k pattern selection for the cross-host exchange
    (DESIGN.md §3).

    Entries are ranked by Δ hit counter (descending — the patterns that
    actually pruned rows travel first), ties broken by (order position,
    vertex) ascending, so every host selects the identical set from the
    same table state. This replaces the old fixed-seed
    ``np.random.default_rng(0)`` sample, which was only accidentally
    deterministic and ignored pattern usefulness entirely.

    Within one host all shards already share the full table
    (shard-as-segments), so this export exists only for cross-host
    replication. μ > 0 patterns reference the sending host's φ
    numbering: they are sound to import only if the receiver raised its
    φ floor above the sender's ids (checkpoint restore does); otherwise
    keep ``transferable_only=True`` and ship μ == 0 patterns, whose
    match condition Φ[0] == 0 holds in every engine.

    ``entries`` is a pattern entries dict (``patterns.store``); the
    returned dict holds only the selected entries, still sorted by
    (pos, v).
    """
    return select_entries(entries, top_k,
                          transferable_only=transferable_only)


@dataclasses.dataclass
class Checkpoint:
    """Elastic snapshot of one distributed match (segment granularity).

    ``pending_roots`` are *data-vertex ids* of root candidates whose
    subtree was not fully resolved at snapshot time — restore re-seeds
    exactly those roots (onto any shard count) and deduplicates
    re-enumerated embeddings. ``entries`` carries the learned Δ in the
    layout-independent entries form (``patterns.store``, hit counters
    included) so restore works under any pattern-store capacity;
    ``phi_floor`` is the writer's φ ceiling, which the restoring
    scheduler reserves so μ > 0 patterns stay sound.
    """
    version: int
    pending_roots: np.ndarray | None          # int32 [P] (v2+)
    embeddings: list                          # list of int32 [n_query]
    entries: dict | None                      # Δ entries dict (v3)
    phi_floor: int = 1
    n_shards: int = 0
    # legacy (v1 JSON): root-candidate *index* ranges instead of ids
    pending_index_ranges: list | None = None


class DistributedMatcher:
    """Search-tree-partitioned matching as a thin front-end over the
    request/handle API (shard-as-segments): :meth:`submit` returns a
    non-blocking :class:`~repro_torch.api.MatchHandle` whose ``stream()``
    yields embedding batches as the shards' waves emit them;
    :meth:`match` is the blocking wrapper that adds checkpointing."""

    def __init__(self, data: Graph, n_shards: int = 4,
                 share_patterns: bool = True,
                 share_top_k: int = 4096,
                 checkpoint_every_waves: int = 8,
                 options: MatchOptions | None = None, device="cuda",
                 **knobs):
        """Engine knobs (``wave_size``, ``kpr``, ``megastep_depth``,
        ``adaptive_prune_threshold``, ``pattern_capacity``,
        ``pattern_cache``, …) resolve through
        :class:`repro_torch.api.MatchOptions` — the shared surface with
        the scheduler and the server. ``device`` (default ``"cuda"``)
        places the engine; without a card the default raises."""
        from ..api.session import MatchSession   # deferred: layering
        self.data = data
        self.n_shards = int(n_shards)
        self.share_patterns = share_patterns
        self.share_top_k = share_top_k
        # shared mode: ONE resident query whose n_shards root segments
        # share one slot-private Δ store. Ablation mode: one isolated
        # scheduler query (own slot, own store) per shard.
        opts = MatchOptions.resolve(options, **knobs).replace(
            n_slots=(1 if share_patterns else self.n_shards))
        # micro-checkpoint cadence (DESIGN.md §8): the MatchOptions knob
        # overrides the ctor arg so the serving surface can tune it
        self.checkpoint_every_waves = int(
            opts.micro_checkpoint_every
            if opts.micro_checkpoint_every is not None
            else checkpoint_every_waves)
        self._faults = opts.faults
        self._session = MatchSession(data, options=opts, device=device)
        self.scheduler = self._session.scheduler
        self._entries: dict | None = None     # last match's Δ snapshot

    # -- non-blocking entry -------------------------------------------------
    def submit(self, query: Graph, *,
               options: MatchOptions | None = None,
               cand: list | None = None, order=None, **overrides):
        """Submit one query as ``n_shards`` intra-query shards; returns
        a :class:`~repro_torch.api.MatchHandle` immediately. The handle's
        ``stream()`` yields embedding batches as the shards find them
        (all shards share one slot-private Δ), ``cancel()`` evicts the
        whole sharded query. Requires ``share_patterns=True`` (the
        isolated-shard ablation has no single resident query to hand
        back)."""
        if not self.share_patterns:
            raise ValueError(
                "submit() requires share_patterns=True (the isolated-"
                "shard ablation runs one scheduler query per shard)")
        return self._session.submit(
            query, options=options, cand=cand, order=order,
            parallelism=self.n_shards, keep_table=True, **overrides)

    # -- main entry ---------------------------------------------------------
    def match(self, query: Graph, limit: int | None = 1000,
              checkpoint_dir: str | None = None, resume: bool = False,
              max_rows: int | None = None) -> MatchResult:
        """Match ``query`` across ``n_shards`` intra-query shards.

        ``checkpoint_dir``: snapshot progress every
        ``checkpoint_every_waves`` scheduler steps (and once at the
        end). ``resume=True`` restores the latest snapshot from that
        directory — possibly written under a different shard count —
        re-seeding only unresolved roots and keeping the learned Δ.
        ``max_rows`` bounds the row budget (mainly to exercise
        mid-flight aborts + restore in tests).
        """
        if checkpoint_dir is not None and not self.share_patterns:
            # fail fast, before load_state/reserve_phi_floor touch any
            # state: the isolated-shard ablation has no snapshot path,
            # and a silently ignored checkpoint_dir would lose progress
            # on abort (or resume stale state from an earlier run)
            raise ValueError(
                "checkpointing requires share_patterns=True "
                "(the isolated-shard ablation does not snapshot)")
        cand_by_pos, order, _, _ = _prepare(query, self.data, None, None)
        roots = np.asarray(cand_by_pos[0], np.int32)
        prior = None
        if resume and checkpoint_dir is not None:
            prior = self.load_state(checkpoint_dir)
        if prior is not None:
            pending = self._pending_roots(prior, roots)
            if prior.entries is not None:
                self.scheduler.reserve_phi_floor(prior.phi_floor)
        else:
            pending = roots
        prior_embs = list(prior.embeddings) if prior is not None else []

        if len(pending) == 0 or (
                limit is not None and len(prior_embs) >= limit):
            return self._merge_result(prior_embs, [], EngineStats(), limit)
        # the resumed run may re-enumerate duplicates of prior
        # embeddings (re-seeded pending roots), so its raw limit must
        # leave room for them: dedup happens on the merged union.
        run_limit = (None if limit is None
                     else limit + len(prior_embs))
        sub_cand = self._restrict_roots(cand_by_pos, order, pending,
                                        query.n)
        if not self.share_patterns:
            res = self._match_isolated(query, sub_cand, order, run_limit)
            return self._merge_result(prior_embs, res.embeddings,
                                      res.stats, limit)

        seed_patterns = (prior.entries if prior is not None else None)
        while True:
            h = self.submit(query, limit=run_limit, cand=sub_cand,
                            order=order, max_rows=max_rows,
                            seed_patterns=seed_patterns)
            waves = 0
            lost = False
            while self._session.step():
                waves += 1
                if (checkpoint_dir is not None
                        and waves % self.checkpoint_every_waves == 0):
                    ck = self._snapshot(h.query_id, prior_embs)
                    if ck is not None:
                        self._save_checkpoint(checkpoint_dir, ck)
                # injected shard loss (DESIGN.md §8): the lost shard is
                # a root segment of the one resident query, so its
                # frontier state dies with the query — recovery is
                # restore-from-micro-checkpoint on the survivors
                if (self._faults is not None and self.n_shards > 1
                        and not h.done()
                        and self._faults.poke("shard", wave=waves)
                        is not None):
                    h.cancel()
                    self._session.run()      # drain the teardown
                    self.n_shards -= 1
                    lost = True
                    break
            if not lost:
                break
            # re-seed the lost shard's unresolved roots onto the
            # survivors from the latest micro-checkpoint (or from
            # scratch when there is none — dedup makes that sound)
            recov = (self.load_state(checkpoint_dir)
                     if checkpoint_dir is not None else None)
            if recov is not None:
                pending = self._pending_roots(recov, roots)
                prior_embs = [np.asarray(e, np.int32)
                              for e in recov.embeddings]
                if recov.entries is not None:
                    self.scheduler.reserve_phi_floor(recov.phi_floor)
                seed_patterns = recov.entries
            else:
                pending = roots
            if len(pending) == 0 or (
                    limit is not None and len(prior_embs) >= limit):
                return self._merge_result(prior_embs, [], EngineStats(),
                                          limit)
            run_limit = (None if limit is None
                         else limit + len(prior_embs))
            sub_cand = self._restrict_roots(cand_by_pos, order, pending,
                                            query.n)
        qr = h.result()
        self._entries = self.scheduler.tables.pop(h.query_id, None)
        out = self._merge_result(prior_embs, qr.embeddings, qr.stats,
                                 limit)
        # final snapshot only on clean completion: an aborted run's
        # segments are already evicted, so the last periodic snapshot
        # (still on disk) is the correct restore point.
        if checkpoint_dir is not None and not qr.stats.aborted:
            self._save_checkpoint(checkpoint_dir, Checkpoint(
                version=CHECKPOINT_VERSION,
                pending_roots=np.zeros(0, np.int32),
                embeddings=[np.asarray(e, np.int32)
                            for e in out.embeddings],
                entries=self._entries,
                phi_floor=self.scheduler.pool.id_counter,
                n_shards=self.n_shards))
        return out

    def _save_checkpoint(self, path: str, ck: Checkpoint) -> None:
        """One save, with the ``checkpoint`` fault boundary: an injected
        save failure skips this snapshot (the previous one on disk stays
        the restore point) instead of killing the match."""
        if (self._faults is not None
                and self._faults.poke("checkpoint") is not None):
            return
        self.save_state(path, ck)

    # -- pattern export (cross-host exchange) -------------------------------
    def export_patterns(self, top_k: int | None = None,
                        transferable_only: bool = True) -> dict:
        """Export the last match's Δ for cross-host replication, capped
        at ``top_k`` (default ``share_top_k``) entries selected by
        :func:`select_exchange_patterns` (hit-counter ranked,
        deterministic). Returns a pattern entries dict ready for a
        receiving scheduler's ``seed_patterns``."""
        if self._entries is None:
            raise RuntimeError("no completed shared match to export")
        return select_exchange_patterns(
            self._entries,
            self.share_top_k if top_k is None else top_k,
            transferable_only=transferable_only)

    # -- internals ----------------------------------------------------------
    @staticmethod
    def _pending_roots(prior: Checkpoint, roots: np.ndarray) -> np.ndarray:
        if prior.pending_roots is not None:
            return np.asarray(prior.pending_roots, np.int32)
        # legacy v1: index ranges into the (deterministic) root order
        pend = []
        for lo, hi in prior.pending_index_ranges or []:
            pend.append(roots[int(lo):int(hi)])
        return (np.concatenate(pend).astype(np.int32) if pend
                else np.zeros(0, np.int32))

    @staticmethod
    def _restrict_roots(cand_by_pos, order, pending: np.ndarray,
                        n: int) -> list:
        """Query-vertex-indexed candidate list with the root position
        restricted to ``pending`` (cand_by_pos is position-indexed)."""
        sub_cand: list = [None] * n
        for d in range(n):
            sub_cand[int(order[d])] = (pending if d == 0
                                       else cand_by_pos[d])
        return sub_cand

    def _match_isolated(self, query: Graph, sub_cand: list,
                        order: np.ndarray, limit: int | None) -> MatchResult:
        """Ablation (``share_patterns=False``): one isolated scheduler
        query per shard — private slot, private table, no pattern flow
        between shards. Root ranges are disjoint so results just
        concatenate."""
        sched = self.scheduler
        roots = np.asarray(sub_cand[int(order[0])], np.int32)
        bounds = np.linspace(0, len(roots),
                             self.n_shards + 1).astype(int)
        qids = []
        for i in range(self.n_shards):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            if hi <= lo:
                continue
            shard_cand = list(sub_cand)
            shard_cand[int(order[0])] = roots[lo:hi]
            qids.append(sched.submit(query, limit=limit, cand=shard_cand,
                                     order=order))
        sched.run()
        stats = EngineStats()
        embeddings: list[np.ndarray] = []
        for qid in qids:
            r = sched.finished.pop(qid)
            embeddings.extend(r.embeddings)
            stats.recursions += r.stats.recursions
            stats.rows_created += r.stats.rows_created
            stats.deadend_prunes += r.stats.deadend_prunes
            stats.injectivity_fails += r.stats.injectivity_fails
            stats.patterns_stored += r.stats.patterns_stored
            stats.aborted |= r.stats.aborted
        sched.poll()
        return MatchResult(embeddings, stats)

    @staticmethod
    def _merge_result(prior_embs: list, new_embs: list, stats,
                      limit: int | None) -> MatchResult:
        """Union + dedup (restore re-enumerates roots that were mid-
        flight at snapshot time; ranges are otherwise disjoint)."""
        seen = set()
        uniq: list[np.ndarray] = []
        for e in list(prior_embs) + list(new_embs):
            e = np.asarray(e, np.int32)
            key = e.tobytes()
            if key not in seen:
                seen.add(key)
                uniq.append(e)
        if limit is not None:
            uniq = uniq[:limit]
        stats.found = len(uniq)
        return MatchResult(uniq, stats)

    def _snapshot(self, qid: int, prior_embs: list) -> Checkpoint | None:
        """Checkpoint a *running* shared match at segment granularity:
        root rows whose subtree is not fully resolved come back as
        pending (restore re-explores them and dedups)."""
        sched = self.scheduler
        q = next((s for s in sched.pool.slots
                  if s is not None and s.query_id == qid), None)
        if q is None or not q.active:
            return None
        pending = []
        for seg in q.segments.values():
            if seg.depth != 1 or seg.parent_seg[0] >= 0:
                continue
            rows = ~seg.resolved
            if rows.any():
                pending.append(seg.frontier[rows, 0])
        pending_roots = (np.concatenate(pending).astype(np.int32)
                         if pending else np.zeros(0, np.int32))
        from ..patterns.store import store_to_entries
        from .engine_step import read_store_slot
        q.materialize_hits()          # fold buffered digest hit batches
        entries = store_to_entries(read_store_slot(sched.tb, q.slot),
                                   q.hit_counts)
        return Checkpoint(
            version=CHECKPOINT_VERSION, pending_roots=pending_roots,
            embeddings=([np.asarray(e, np.int32) for e in prior_embs]
                        + [np.asarray(e, np.int32)
                           for e in q.embeddings]),
            entries=entries,
            phi_floor=sched.pool.id_counter, n_shards=self.n_shards)

    # -- checkpoint / elastic restore ---------------------------------------
    @staticmethod
    def save_state(path: str, ck: Checkpoint) -> None:
        """Write a compressed ``state.npz`` snapshot (atomic rename).

        Format v3: ``version``, ``n_shards``, ``phi_floor``,
        ``pending_roots`` (data-vertex ids), ``embeddings`` (int32
        [n_found, n_query]), and the Δ *entries* arrays
        (``delta_pos/v/phi/mu/mask/hits`` — valid entries only, so the
        snapshot is O(patterns), not O(positions × vertices), and
        restores under any store capacity). The shard count is
        informational — restore redistributes pending roots over
        whatever ``n_shards`` the restoring matcher uses.
        """
        p = pathlib.Path(path)
        p.mkdir(parents=True, exist_ok=True)
        embs = (np.stack(ck.embeddings).astype(np.int32)
                if ck.embeddings else np.zeros((0, 0), np.int32))
        payload = {
            "version": np.int64(ck.version),
            "n_shards": np.int64(ck.n_shards),
            "phi_floor": np.int64(ck.phi_floor),
            "pending_roots": np.asarray(
                ck.pending_roots if ck.pending_roots is not None else [],
                np.int32),
            "embeddings": embs,
        }
        if ck.entries is not None:
            for k in ENTRY_KEYS:
                payload[f"delta_{k}"] = np.asarray(ck.entries[k])
        tmp = p / "state.npz.tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
        tmp.rename(p / "state.npz")

    @staticmethod
    def load_state(path: str) -> Checkpoint | None:
        """Load the latest snapshot. Prefers ``state.npz`` (v3 entries;
        v2 dense-table snapshots are converted on read); falls back to
        the legacy ``state.json`` (v1: root-index ranges, no Δ).

        The archive is structurally validated *before* any state is
        assembled: a truncated file, a missing/unreadable field, a
        wrong-shape array or an unsupported version raises
        :class:`CheckpointCorrupt` naming the bad field — callers never
        see a raw numpy/zipfile traceback, and a matcher resuming from
        a corrupt snapshot mutates nothing."""
        p = pathlib.Path(path)
        npz = p / "state.npz"
        if npz.exists():
            try:
                z = np.load(npz)
            except Exception as exc:
                raise CheckpointCorrupt(
                    f"checkpoint {npz} is unreadable (truncated or not "
                    f"an npz archive): {exc}") from exc
            with z:
                files = set(z.files)
                for k in ("version", "n_shards", "phi_floor",
                          "pending_roots", "embeddings"):
                    if k not in files:
                        raise CheckpointCorrupt(
                            f"checkpoint {npz} is missing required "
                            f"field {k!r}")

                def _arr(name: str, ndim: int | None = None):
                    try:
                        a = z[name]
                    except Exception as exc:
                        raise CheckpointCorrupt(
                            f"checkpoint {npz}: field {name!r} is "
                            f"unreadable (truncated member): {exc}"
                        ) from exc
                    if ndim is not None and a.ndim != ndim:
                        raise CheckpointCorrupt(
                            f"checkpoint {npz}: field {name!r} has "
                            f"shape {a.shape}, expected a {ndim}-D "
                            f"array")
                    return a

                def _scalar(name: str) -> int:
                    a = _arr(name)
                    if a.size != 1:
                        raise CheckpointCorrupt(
                            f"checkpoint {npz}: field {name!r} must be "
                            f"a scalar, got shape {a.shape}")
                    return int(a)

                version = _scalar("version")
                if not 1 <= version <= CHECKPOINT_VERSION:
                    raise CheckpointCorrupt(
                        f"checkpoint {npz}: field 'version' = "
                        f"{version} unsupported (expected 1.."
                        f"{CHECKPOINT_VERSION})")
                n_shards = _scalar("n_shards")
                phi_floor = _scalar("phi_floor")
                pending = _arr("pending_roots", ndim=1)
                embs = _arr("embeddings", ndim=2)
                entries = None
                if "delta_pos" in files:
                    for k in ENTRY_KEYS:
                        if f"delta_{k}" not in files:
                            raise CheckpointCorrupt(
                                f"checkpoint {npz} is missing Δ field "
                                f"'delta_{k}' (has delta_pos)")
                    entries = {k: _arr(f"delta_{k}", ndim=1)
                               for k in ENTRY_KEYS}
                    n_ent = len(entries["pos"])
                    for k in ENTRY_KEYS:
                        if len(entries[k]) != n_ent:
                            raise CheckpointCorrupt(
                                f"checkpoint {npz}: field 'delta_{k}' "
                                f"has {len(entries[k])} entries, "
                                f"expected {n_ent} (= len(delta_pos))")
                elif "table_valid" in files:
                    entries = _entries_from_dense_v2(
                        {k: _arr(f"table_{k}") for k in _V2_TABLE_KEYS},
                        _arr("table_hits") if "table_hits" in files
                        else None)
                return Checkpoint(
                    version=version,
                    pending_roots=pending.astype(np.int32),
                    embeddings=[e for e in embs.astype(np.int32)],
                    entries=entries,
                    phi_floor=phi_floor,
                    n_shards=n_shards)
        legacy = p / "state.json"
        if legacy.exists():
            state = json.loads(legacy.read_text())
            ranges = []
            found: list[np.ndarray] = []
            for s in state["shards"]:
                ranges.extend([tuple(r) for r in s["pending"]])
                found.extend(np.asarray(e, np.int32) for e in s["found"])
            return Checkpoint(version=1, pending_roots=None,
                              embeddings=found, entries=None,
                              pending_index_ranges=ranges,
                              n_shards=len(state["shards"]))
        return None


def _entries_from_dense_v2(table: dict, hits: np.ndarray | None) -> dict:
    """Convert a legacy v2 dense ``[N_PAD, V]`` table snapshot to the
    entries form (one-release read compatibility)."""
    valid = np.asarray(table["valid"])
    pos, vert = np.nonzero(valid)
    from ..patterns.store import mask64
    return {"pos": pos.astype(np.int32), "v": vert.astype(np.int32),
            "phi": np.asarray(table["phi"])[pos, vert].astype(np.int32),
            "mu": np.asarray(table["mu"])[pos, vert].astype(np.int32),
            "mask": mask64(np.asarray(table["mask"])[pos, vert]),
            "hits": (np.asarray(hits)[pos, vert].astype(np.int64)
                     if hits is not None
                     else np.zeros(len(pos), np.int64))}
