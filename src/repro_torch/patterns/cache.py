"""Cross-query pattern cache: warm-start Δ for recurring query templates.

A serving system with millions of users sees the same query *templates*
over and over (the same shape/labels, often literally the same query).
The paper's table Δ dies with its query slot, so every resubmission
relearns the same dead-ends from scratch. :class:`PatternCache` closes
that loop on the host: when a learning query retires, its hot patterns
are snapshotted under a canonical template fingerprint; when an
equivalent template is admitted later, the snapshot warm-starts the new
slot's store so known dead-ends prune from the very first wave.

Template canonicalization — *exact device-array identity*. The engine's
behavior for a query is fully determined by the order-permuted device
arrays it is loaded with: ``(n_query, cand_bitmap, nbr_mask)``. The
fingerprint is a digest of exactly those bytes, so two queries share a
cache line iff the engine literally cannot tell them apart (isomorphic
queries normalize to the same arrays whenever the candidate filters and
ordering heuristic map them the same way — no graph-isomorphism solve
is needed, and there are no false positives by construction).

Soundness — *μ == 0 entries only*. A μ == 0 pattern's set form is
``{(key_pos, key_v)}`` ⊆ the key itself, and its numeric condition
``Φ[0] == 0`` holds for every row of every query (root prefixes all
share id 0): it asserts "mapping this order position to this data vertex
is dead regardless of the prefix", which transfers verbatim to any query
with identical device arrays. μ > 0 entries reference the writer's φ
numbering and would never fire for a fresh query anyway (its prefix ids
are all newer), so the cache does not spend capacity on them.

The cache itself is bounded: ``max_templates`` LRU template lines of at
most ``top_k`` entries each (hit-counter ranked) — O(configured size)
resident memory, independent of data-graph or traffic scale.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib

import numpy as np

from .store import ENTRY_KEYS, select_entries


@dataclasses.dataclass
class CacheStats:
    lookups: int = 0
    hits: int = 0
    inserts: int = 0
    evictions: int = 0
    warm_patterns: int = 0      # total entries handed out on hits


class PatternCache:
    """LRU map: template fingerprint -> hot μ == 0 pattern entries."""

    def __init__(self, max_templates: int = 64, top_k: int = 512):
        self.max_templates = int(max_templates)
        self.top_k = int(top_k)
        self._lines: collections.OrderedDict[bytes, dict] = \
            collections.OrderedDict()
        self.stats = CacheStats()

    @staticmethod
    def fingerprint(n_query: int, cand_bitmap: np.ndarray,
                    nbr_mask: np.ndarray) -> bytes:
        """Canonical template key: digest of the exact device arrays."""
        h = hashlib.sha1()
        h.update(int(n_query).to_bytes(4, "little"))
        h.update(np.ascontiguousarray(cand_bitmap).tobytes())
        h.update(np.ascontiguousarray(nbr_mask).tobytes())
        return h.digest()

    def __len__(self) -> int:
        return len(self._lines)

    def get(self, fp: bytes) -> dict | None:
        """Entries for a template (or None). Counts as one lookup."""
        self.stats.lookups += 1
        line = self._lines.get(fp)
        if line is None or len(line["pos"]) == 0:
            return None
        self._lines.move_to_end(fp)
        self.stats.hits += 1
        self.stats.warm_patterns += len(line["pos"])
        return {k: line[k].copy() for k in ENTRY_KEYS}

    def put(self, fp: bytes, entries: dict) -> int:
        """Fold a retiring query's entries into the template's line.

        Only μ == 0 entries are kept (see module docstring). An existing
        line is merged by key with hit counters summed (recurring
        dead-ends accumulate weight), then re-ranked and capped at
        ``top_k``. Returns the number of entries now cached for the
        template (0 = nothing transferable, no line written).
        """
        # pre-cap at top_k so the merge loop below is bounded by
        # 2·top_k, not by the retiring store's full occupancy
        new = select_entries(entries, self.top_k, transferable_only=True)
        old = self._lines.get(fp)
        if old is not None:
            merged: dict[tuple[int, int], list] = {}
            for src in (old, new):
                for i in range(len(src["pos"])):
                    key = (int(src["pos"][i]), int(src["v"][i]))
                    if key in merged:
                        merged[key][5] += int(src["hits"][i])
                    else:
                        merged[key] = [src[k][i] for k in ENTRY_KEYS]
            keys = sorted(merged)
            new = {k: np.asarray([merged[key][i] for key in keys],
                                 dtype=new[k].dtype)
                   for i, k in enumerate(ENTRY_KEYS)}
        new = select_entries(new, self.top_k, transferable_only=True)
        if len(new["pos"]) == 0:
            return 0
        if old is None and len(self._lines) >= self.max_templates:
            self._lines.popitem(last=False)
            self.stats.evictions += 1
        self._lines[fp] = new
        self._lines.move_to_end(fp)
        self.stats.inserts += 1
        return len(new["pos"])

    def report(self) -> dict:
        s = self.stats
        return {"templates": len(self._lines),
                "lookups": s.lookups, "hits": s.hits,
                "inserts": s.inserts, "evictions": s.evictions,
                "warm_patterns": s.warm_patterns}
