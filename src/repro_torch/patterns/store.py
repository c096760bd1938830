"""Bounded hashed device store for failure patterns (Δ, paper §4.4).

PyTorch twin of ``repro/patterns/store.py``: a per-slot open-addressing
hash store ``[S, C]`` keyed by ``(order position, data vertex)`` holding
the paper's numeric pattern ``(φ, μ, Γ)`` plus a hit counter; probes and
inserts use the same multiplicative hash, ``PROBE``-slot linear window,
in-batch last-write-wins dedup and counter-guided eviction, bit for bit.

Differences of form, not of result:

* masks ``Γ`` are int32 ``[..., MASK_WORDS]`` words (the reference's
  uint32 bit patterns); the hashes run on the unsigned value in int64
  (``kernels.bitops``), so uint32 wraparound and logical shifts hold;
* the reference's banks are immutable and its programs donate them;
  here :func:`hash_insert` and :func:`age_hits` update the bank's
  tensors **in place** and return the same bank;
* ``.at[...].set(mode="drop")`` becomes :func:`masked_put_`, a scatter
  whose masked rows write a value that is already being written.

Soundness is the reference's: the table is advisory, a lost pattern
only loses pruning.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.bitops import mul32, u32
from ..roofline.hlo_cost import loop_condition

MASK_WORDS = 2          # dead-end masks cover up to 64 query positions
PROBE = 8               # linear-probe window length
INSERT_ROUNDS = 3       # in-batch conflict retries

ENTRY_KEYS = ("pos", "v", "phi", "mu", "mask", "hits")

I32 = torch.int32


class PatternStore(NamedTuple):
    """One query slot's hashed Δ store (capacity C entries)."""
    key_pos: torch.Tensor    # int32 [C] order position of the key (-1 empty)
    key_v: torch.Tensor      # int32 [C] data vertex of the key
    phi: torch.Tensor        # int32 [C] stored prefix id φ
    mu: torch.Tensor         # int32 [C] prefix length μ
    mask: torch.Tensor       # int32 [C, MASK_WORDS] dead-end mask Γ
    valid: torch.Tensor      # bool [C]
    hits: torch.Tensor       # int32 [C] device hit counter (aged)

    @staticmethod
    def empty(capacity: int, device) -> "PatternStore":
        c = _check_capacity(capacity)
        return PatternStore(
            key_pos=torch.full((c,), -1, dtype=I32, device=device),
            key_v=torch.full((c,), -1, dtype=I32, device=device),
            phi=torch.zeros((c,), dtype=I32, device=device),
            mu=torch.zeros((c,), dtype=I32, device=device),
            mask=torch.zeros((c, MASK_WORDS), dtype=I32, device=device),
            valid=torch.zeros((c,), dtype=torch.bool, device=device),
            hits=torch.zeros((c,), dtype=I32, device=device))


class PatternStoreBank(NamedTuple):
    """Per-slot hashed Δ stores, stacked along the query-slot axis."""
    key_pos: torch.Tensor    # int32 [S, C]
    key_v: torch.Tensor      # int32 [S, C]
    phi: torch.Tensor        # int32 [S, C]
    mu: torch.Tensor         # int32 [S, C]
    mask: torch.Tensor       # int32 [S, C, MASK_WORDS]
    valid: torch.Tensor      # bool [S, C]
    hits: torch.Tensor       # int32 [S, C]

    @property
    def capacity(self) -> int:
        return self.phi.shape[1]

    @staticmethod
    def empty(n_slots: int, capacity: int,
              device) -> "PatternStoreBank":
        c = _check_capacity(capacity)
        s = n_slots
        return PatternStoreBank(
            key_pos=torch.full((s, c), -1, dtype=I32, device=device),
            key_v=torch.full((s, c), -1, dtype=I32, device=device),
            phi=torch.zeros((s, c), dtype=I32, device=device),
            mu=torch.zeros((s, c), dtype=I32, device=device),
            mask=torch.zeros((s, c, MASK_WORDS), dtype=I32, device=device),
            valid=torch.zeros((s, c), dtype=torch.bool, device=device),
            hits=torch.zeros((s, c), dtype=I32, device=device))


class StoreCounters(NamedTuple):
    """Per-slot insert accounting of one batched scatter (int32 [S])."""
    stored: torch.Tensor
    overwrites: torch.Tensor
    evictions: torch.Tensor
    dropped: torch.Tensor

    @staticmethod
    def zeros(n_slots: int, device) -> "StoreCounters":
        z = torch.zeros((n_slots,), dtype=I32, device=device)
        return StoreCounters(z, z, z, z)

    def add(self, other: "StoreCounters") -> "StoreCounters":
        return StoreCounters(*(a + b for a, b in zip(self, other)))


def _check_capacity(capacity: int) -> int:
    c = int(capacity)
    if c < PROBE or (c & (c - 1)) != 0:
        raise ValueError(
            f"pattern store capacity must be a power of two >= {PROBE}, "
            f"got {capacity}")
    return c


def masked_put_(dst: torch.Tensor, idx: tuple, vals, mask: torch.Tensor
                ) -> None:
    """In-place ``dst[idx[0][m], idx[1][m], ...] = vals[m]`` for the rows
    ``m`` where ``mask`` holds — the reference's ``.at[].set(mode=
    "drop")`` with the masked rows routed out of bounds.

    No host sync and no copy of ``dst``: every masked row is redirected
    to the first unmasked row's target with that row's value, so it
    duplicates a write that happens anyway (equal values — a defined
    result even where scatter order is not). With no unmasked row at
    all, each row rewrites the current value of one in-range target.
    The unmasked targets must be distinct or carry equal values.
    """
    n = mask.shape[0]
    rest = tuple(dst.shape[len(idx):])
    if not torch.is_tensor(vals):
        vals = torch.tensor(vals, dtype=dst.dtype, device=dst.device)
    vals = vals.to(dst.dtype).expand((n,) + rest)
    safe = tuple(i.clamp(0, dst.shape[d] - 1) for d, i in enumerate(idx))
    # a 1-element index, not a 0-d one: indexing with a 0-d tensor reads
    # it back to the host (a device sync)
    first = torch.argmax(mask.to(I32)).reshape(1)
    pick = tuple(s[first] for s in safe)
    fallback = torch.where(mask.any(), vals[first], dst[pick])
    m = mask.view((n,) + (1,) * len(rest))
    dst.index_put_(tuple(torch.where(mask, s, p)
                         for s, p in zip(safe, pick)),
                   torch.where(m, vals, fallback))


def _hash0(key_pos: torch.Tensor, key_v: torch.Tensor,
           capacity: int) -> torch.Tensor:
    """Multiplicative hash of (pos, v) onto [0, capacity) (uint32
    arithmetic on the unsigned values)."""
    h = mul32(u32(key_v), 2654435761) ^ mul32(u32(key_pos), 0x9E3779B9)
    h = h ^ (h >> 15)
    return (h & (capacity - 1)).to(I32)


def _hash0_np(key_pos: np.ndarray, key_v: np.ndarray,
              capacity: int) -> np.ndarray:
    """Host twin of :func:`_hash0` (numpy uint32 wraps by definition)."""
    h = (np.asarray(key_v).astype(np.uint32) * np.uint32(2654435761)
         ^ np.asarray(key_pos).astype(np.uint32) * np.uint32(0x9E3779B9))
    h ^= h >> np.uint32(15)
    return (h & np.uint32(capacity - 1)).astype(np.int32)


def probe_slots(key_pos: torch.Tensor, key_v: torch.Tensor,
                capacity: int) -> torch.Tensor:
    """Linear-probe window: int64 [..., PROBE] store indices per key."""
    h0 = _hash0(key_pos, key_v, capacity).to(torch.int64)
    offs = torch.arange(PROBE, device=h0.device)
    return (h0[..., None] + offs) & (capacity - 1)


def hash_probe(bank: PatternStoreBank, slot: torch.Tensor,
               key_pos: torch.Tensor, key_v: torch.Tensor
               ) -> tuple[torch.Tensor, ...]:
    """Probe flat key arrays [M] against the bank.

    Returns (found bool [M], phi int32 [M], mu int32 [M],
    mask int32 [M, MASK_WORDS], idx int64 [M]); ``idx`` is the matched
    store index (0 when not found — gate on ``found``).
    """
    c = bank.capacity
    ps = probe_slots(key_pos, key_v, c)                      # [M, P]
    s2 = slot.to(torch.int64)[:, None]
    match = (bank.valid[s2, ps]
             & (bank.key_pos[s2, ps] == key_pos[:, None])
             & (bank.key_v[s2, ps] == key_v[:, None]))      # [M, P]
    found = match.any(dim=1)
    j = torch.argmax(match.to(I32), dim=1)                   # first match
    idx = ps.gather(1, j[:, None])[:, 0]
    idx = torch.where(found, idx, 0)
    sl = torch.where(found, slot.to(torch.int64), 0)
    return (found, bank.phi[sl, idx], bank.mu[sl, idx],
            bank.mask[sl, idx], idx)


def _count_per_slot(sel: torch.Tensor, slot: torch.Tensor,
                    n_slots: int) -> torch.Tensor:
    out = torch.zeros((n_slots + 1,), dtype=I32, device=sel.device)
    out.index_put_((torch.where(sel, slot.to(torch.int64), n_slots),),
                   torch.ones_like(sel, dtype=I32), accumulate=True)
    return out[:n_slots]


def hash_insert(bank: PatternStoreBank, slot: torch.Tensor,
                key_pos: torch.Tensor, key_v: torch.Tensor,
                phis: torch.Tensor, mus: torch.Tensor, masks: torch.Tensor,
                valid: torch.Tensor
                ) -> tuple[PatternStoreBank, StoreCounters]:
    """Batched Δ insert with counter-guided eviction (flat arrays [N]),
    updating ``bank`` in place. Same target selection, in-batch dedup
    and retry rule as the reference: up to ``INSERT_ROUNDS`` rounds,
    each run only while some entry still needs one (the condition is
    read back to the host once per round)."""
    n_slots = bank.valid.shape[0]
    counters = StoreCounters.zeros(n_slots, valid.device)
    remaining = valid
    for r in range(INSERT_ROUNDS):
        if not loop_condition(remaining.any(), r == 0):
            break
        round_counters, remaining = _insert_round(
            bank, slot, key_pos, key_v, phis, mus, masks, remaining)
        counters = counters.add(round_counters)
    return bank, counters._replace(
        dropped=counters.dropped + _count_per_slot(remaining, slot,
                                                   n_slots))


def _insert_round(bank: PatternStoreBank, slot: torch.Tensor,
                  key_pos: torch.Tensor, key_v: torch.Tensor,
                  phis: torch.Tensor, mus: torch.Tensor,
                  masks: torch.Tensor, valid: torch.Tensor
                  ) -> tuple[StoreCounters, torch.Tensor]:
    """One conflict-resolution round of :func:`hash_insert` (writes the
    bank in place). Returns this round's counters and the entries still
    to insert."""
    n = slot.shape[0]
    n_slots, c = bank.valid.shape
    dev = valid.device
    slot64 = slot.to(torch.int64)
    ps = probe_slots(key_pos, key_v, c)                      # [N, P]
    s2 = torch.where(valid, slot64, 0)[:, None]
    wvalid = bank.valid[s2, ps]
    match = (wvalid & (bank.key_pos[s2, ps] == key_pos[:, None])
             & (bank.key_v[s2, ps] == key_v[:, None]))
    whits = bank.hits[s2, ps]
    has_match = match.any(dim=1)
    empty = ~wvalid
    has_empty = empty.any(dim=1)
    arange = torch.arange(n, dtype=torch.int64, device=dev)
    # the empty-slot pick spreads distinct keys over the window by a
    # second hash of the KEY (see the reference for why not by position)
    spread = (mul32(u32(key_v), 0x85EBCA6B)
              ^ mul32(u32(key_pos), 0xC2B2AE35))
    spread = spread ^ (spread >> 13)
    n_empty = empty.sum(dim=1)
    want = (spread % n_empty.clamp(min=1))[:, None]          # unsigned mod
    ranks = torch.cumsum(empty.to(torch.int64), dim=1) - 1
    j_empty = torch.argmax((empty & (ranks == want)).to(I32), dim=1)
    j = torch.where(has_match, torch.argmax(match.to(I32), dim=1),
                    torch.where(has_empty, j_empty,
                                torch.argmin(whits, dim=1)))
    target = ps.gather(1, j[:, None])[:, 0]                  # [N]

    # in-batch dedup: exactly one winner per (slot, target) pair — the
    # last index, as the reference's scatter-max of the batch position
    flat = (slot64 * c + target).clamp(0, n_slots * c - 1)
    winner = torch.full((n_slots * c + 1,), -1, dtype=torch.int64,
                        device=dev)
    winner.scatter_reduce_(0, torch.where(valid, flat, n_slots * c),
                           torch.where(valid, arange, -1), "amax")
    wflat = winner[flat]
    keep = valid & (wflat == arange)
    widx = wflat.clamp(min=0)
    same_key = (key_pos == key_pos[widx]) & (key_v == key_v[widx])
    kept_hits = torch.where(has_match, whits.gather(1, j[:, None])[:, 0],
                            0)
    at = (slot64, target)
    masked_put_(bank.key_pos, at, key_pos, keep)
    masked_put_(bank.key_v, at, key_v, keep)
    masked_put_(bank.phi, at, phis, keep)
    masked_put_(bank.mu, at, mus, keep)
    masked_put_(bank.mask, at, masks, keep)
    masked_put_(bank.valid, at, True, keep)
    masked_put_(bank.hits, at, kept_hits, keep)

    superseded = valid & ~keep & same_key
    retry = valid & ~keep & ~same_key
    counters = StoreCounters(
        stored=_count_per_slot(keep, slot, n_slots),
        overwrites=_count_per_slot((keep & has_match) | superseded,
                                   slot, n_slots),
        evictions=_count_per_slot(keep & ~has_match & ~has_empty,
                                  slot, n_slots),
        dropped=torch.zeros((n_slots,), dtype=I32, device=dev))
    return counters, retry


def age_hits(bank: PatternStoreBank) -> PatternStoreBank:
    """Halve every hit counter, in place (periodic aging)."""
    bank.hits.bitwise_right_shift_(1)
    return bank


# ===================================================================
# host-side entries form (numpy) — layout-independent snapshot
# ===================================================================
def mask64(words: np.ndarray) -> np.ndarray:
    """uint32 (or int32 bit pattern) [..., 2] -> uint64 [...]."""
    w = np.asarray(words)
    if w.dtype == np.int32:
        w = w.view(np.uint32)
    w = w.astype(np.uint64)
    return w[..., 0] | (w[..., 1] << np.uint64(32))


def words_from64(m: np.ndarray) -> np.ndarray:
    out = np.zeros(np.shape(m) + (MASK_WORDS,), np.uint32)
    out[..., 0] = (m & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[..., 1] = (m >> np.uint64(32)).astype(np.uint32)
    return out


def empty_entries() -> dict:
    return {"pos": np.zeros(0, np.int32), "v": np.zeros(0, np.int32),
            "phi": np.zeros(0, np.int32), "mu": np.zeros(0, np.int32),
            "mask": np.zeros(0, np.uint64), "hits": np.zeros(0, np.int64)}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def store_to_entries(store: PatternStore,
                     hit_counts: dict | None = None) -> dict:
    """Snapshot a slot's store into the compact entries dict, sorted by
    (pos, v); ``hit_counts`` (host-cumulative ``{(pos, v): n}``)
    overrides the device hit lane where larger."""
    valid = _np(store.valid)
    sel = np.nonzero(valid)[0]
    pos = _np(store.key_pos)[sel]
    v = _np(store.key_v)[sel]
    order = np.lexsort((v, pos))
    pos, v, sel = pos[order], v[order], sel[order]
    hits = _np(store.hits)[sel].astype(np.int64)
    if hit_counts:
        hk = np.fromiter(((p << 32) | vv for p, vv in hit_counts),
                         np.int64, len(hit_counts))
        hv = np.fromiter(hit_counts.values(), np.int64, len(hit_counts))
        ho = np.argsort(hk)
        hk, hv = hk[ho], hv[ho]
        ek = (pos.astype(np.int64) << 32) | v
        idx = np.clip(np.searchsorted(hk, ek), 0, len(hk) - 1)
        matched = hk[idx] == ek
        hits = np.where(matched, np.maximum(hits, hv[idx]), hits)
    return {"pos": pos.astype(np.int32), "v": v.astype(np.int32),
            "phi": _np(store.phi)[sel].astype(np.int32),
            "mu": _np(store.mu)[sel].astype(np.int32),
            "mask": mask64(_np(store.mask)[sel]),
            "hits": hits}


def entries_to_store(entries: dict, capacity: int,
                     device) -> PatternStore:
    """Rebuild a store from an entries dict (any capacity): hottest
    first, same hash/probe layout as the device, a full window drops
    the (colder) newcomer — the reference's placement exactly."""
    c = _check_capacity(capacity)
    key_pos = np.full(c, -1, np.int32)
    key_v = np.full(c, -1, np.int32)
    phi = np.zeros(c, np.int32)
    mu = np.zeros(c, np.int32)
    mask = np.zeros((c, MASK_WORDS), np.uint32)
    valid = np.zeros(c, bool)
    hits = np.zeros(c, np.int32)
    pos_a = np.asarray(entries["pos"], np.int32)
    v_a = np.asarray(entries["v"], np.int32)
    h_a = np.asarray(entries["hits"], np.int64)
    order = np.lexsort((v_a, pos_a, -h_a))
    pos_a, v_a, h_a = pos_a[order], v_a[order], h_a[order]
    phi_a = np.asarray(entries["phi"], np.int32)[order]
    mu_a = np.asarray(entries["mu"], np.int32)[order]
    mask_words = words_from64(np.asarray(entries["mask"], np.uint64))[order]
    h0 = _hash0_np(pos_a, v_a, c)
    placed = np.zeros(len(pos_a), bool)
    for off in range(PROBE):
        rem = np.nonzero(~placed)[0]
        if len(rem) == 0:
            break
        t = (h0[rem] + off) & (c - 1)
        _, first = np.unique(t, return_index=True)
        winner = np.zeros(len(rem), bool)
        winner[first] = True
        ok = winner & ~valid[t]
        sel, ts = rem[ok], t[ok]
        key_pos[ts] = pos_a[sel]
        key_v[ts] = v_a[sel]
        phi[ts] = phi_a[sel]
        mu[ts] = mu_a[sel]
        mask[ts] = mask_words[sel]
        valid[ts] = True
        hits[ts] = np.minimum(h_a[sel], 2**31 - 1).astype(np.int32)
        placed[sel] = True

    def t(a):
        return torch.from_numpy(a).to(device)
    return PatternStore(key_pos=t(key_pos), key_v=t(key_v), phi=t(phi),
                        mu=t(mu), mask=t(mask.view(np.int32)),
                        valid=t(valid), hits=t(hits))


def select_entries(entries: dict, top_k: int | None,
                   transferable_only: bool = True) -> dict:
    """Deterministic top-k selection over an entries dict (hit counter
    descending, ties by (pos, v)); ``transferable_only`` keeps μ == 0."""
    sel = np.ones(len(entries["pos"]), bool)
    if transferable_only:
        sel &= np.asarray(entries["mu"]) == 0
    idx = np.nonzero(sel)[0]
    if top_k is not None and len(idx) > top_k:
        pos = np.asarray(entries["pos"])[idx]
        v = np.asarray(entries["v"])[idx]
        h = np.asarray(entries["hits"])[idx]
        rank = np.lexsort((v, pos, -h))
        idx = np.sort(idx[rank[:top_k]])
    return {k: np.asarray(entries[k])[idx] for k in ENTRY_KEYS}
