"""Host reference implementations of the dead-end pattern table Δ
(paper §4.4) plus the shared stats record.

Two interchangeable table implementations:

* :class:`SetDeadEndTable` — stores patterns as explicit mapping sets and
  matches with real ``D ⊆ M̂`` containment. O(|D|) per check. Used by tests
  as the semantic reference for the numeric representation.

* :class:`NumericDeadEndTable` — the paper's O(1) scheme (§4.4.2): each
  pattern is the triplet ``(φ, μ, Γ)`` where ``φ`` is the embedding ID of
  the storing embedding's length-``μ`` prefix and ``Γ`` is the dead-end
  mask (kept for Lemma-3 propagation). A partial embedding with ancestor
  ID array ``Φ`` matches iff ``Φ[μ] == φ``. This matches *fewer* embeddings
  than true containment (prefix-identity is stronger than subset), hence
  remains sound; in exchange both lookup and match are O(1).

Keys: the paper keys the hash table by the last mapping ``(u_k, v)``.
Since the matching order fixes which query vertex sits at each depth, we
key by ``(depth_position, data_vertex)``.

Both tables are *advisory*: overwrites or capacity evictions can only lose
pruning opportunities, never correctness (Theorem 1 relies only on every
stored pattern being a true dead-end). The device-side bounded hashed
store (``patterns.store``) leans on exactly this invariant for its
counter-guided eviction; :class:`DeadEndStats` is the shared accounting
record for both — the engine fills the eviction/occupancy fields from the
megastep digest counters.

With device-resident stacks (``engine_step.run_device_megastep``) the
in-loop Δ stores are fed from rows that never exist on the host: Lemma-1
patterns at expansion time and Lemma-4 patterns at on-device finalize
(``_resolution_sweep``), both through ``store_patterns_mq`` against the
same advisory invariant. The host tables here stay the oracle the
device-path equality tests pin against.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DeadEndStats:
    stores: int = 0
    # per-probe lookup count: maintained by the host reference tables
    # only — the engine's device digest carries no lookup count, so on
    # the engine path this stays 0 while ``hits`` counts Δ prunes
    lookups: int = 0
    hits: int = 0
    overwrites: int = 0
    # bounded-store accounting (device hashed Δ; always 0 for the
    # unbounded host reference tables)
    evictions: int = 0
    dropped: int = 0
    occupancy: int = 0          # valid entries at read-out time
    capacity: int = 0           # 0 = unbounded


class SetDeadEndTable:
    """Reference implementation with exact subset matching."""

    def __init__(self, n_query: int):
        self.n_query = n_query
        self.table: dict[tuple[int, int], frozenset[tuple[int, int]]] = {}
        self.stats = DeadEndStats()

    def store(self, pos: int, v: int, mapping: list[int],
              mask_positions: frozenset[int], phi: np.ndarray) -> None:
        """Record pattern {(p, mapping[p]) : p in mask} at key (pos, v).

        ``mapping`` is the current partial embedding as a list of data
        vertices indexed by order position; ``pos`` is the position of the
        last mapping (== len(mapping) - 1) and ``v == mapping[pos]``.
        """
        del phi  # unused in the set representation
        pattern = frozenset((p, mapping[p]) for p in mask_positions)
        if (pos, v) in self.table:
            self.stats.overwrites += 1
        self.table[(pos, v)] = pattern
        self.stats.stores += 1

    def match(self, pos: int, v: int, mapping: list[int],
              phi: np.ndarray) -> frozenset[int] | None:
        """If extending with position ``pos`` -> ``v`` hits a pattern,
        return the pattern's mask positions (for Lemma 3); else None."""
        del phi
        self.stats.lookups += 1
        pat = self.table.get((pos, v))
        if pat is None:
            return None
        for (p, pv) in pat:
            if p >= len(mapping) or mapping[p] != pv:
                return None
        self.stats.hits += 1
        return frozenset(p for p, _ in pat)


class NumericDeadEndTable:
    """The paper's O(1) numeric representation (§4.4.2)."""

    def __init__(self, n_query: int):
        self.n_query = n_query
        # key (pos, v) -> (phi_id, mu_len, mask_positions)
        self.table: dict[tuple[int, int], tuple[int, int, frozenset[int]]] = {}
        self.stats = DeadEndStats()

    def store(self, pos: int, v: int, mapping: list[int],
              mask_positions: frozenset[int], phi: np.ndarray) -> None:
        # ignore the key's own position (the key encodes it, §4.4.2)
        below = [p for p in mask_positions if p < pos]
        mu_len = (max(below) + 1) if below else 0
        phi_id = int(phi[mu_len])
        if (pos, v) in self.table:
            self.stats.overwrites += 1
        self.table[(pos, v)] = (phi_id, mu_len, frozenset(mask_positions))
        self.stats.stores += 1

    def match(self, pos: int, v: int, mapping: list[int],
              phi: np.ndarray) -> frozenset[int] | None:
        self.stats.lookups += 1
        entry = self.table.get((pos, v))
        if entry is None:
            return None
        phi_id, mu_len, mask = entry
        if int(phi[mu_len]) != phi_id:
            return None
        self.stats.hits += 1
        return mask
