"""Device programs of the wave engine, in PyTorch.

Twin of ``repro/core/engine_step.py`` on the dense adjacency layout: the
banks (:class:`QueryBank`, :class:`StackBank`, the hashed Δ store), the
expansion pieces (Eq. 2 refinement, injectivity masking, packed top-kpr
extraction, the Eq. 7 dead-end probe), the host-scheduled programs
(:func:`expand_wave_mq`, :func:`extract_more_mq`,
:func:`assemble_children_mq` and the ring megastep
:func:`run_megastep_mq`), the Lemma-1 in-loop stores, the Lemma-4
resolution sweep, and :func:`run_device_megastep`, the device-resident
DFS loop. Every lane equals the reference's bit for bit (held by
``tests/test_torch_engine_step.py`` and
``tests/test_torch_host_programs.py``).

PyTorch idiom, and where it departs from the reference's form:

* packed words and Γ masks are int32 tensors (``kernels.bitops`` does
  the uint32 arithmetic); indices are int64;
* the reference donates the Δ store bank and the stack bank to the
  step; here they are updated **in place** (:func:`masked_put_`
  replaces ``.at[].set(mode="drop")``), while everything the host reads
  afterwards — the digest lanes and the embedding batch — is allocated
  fresh per call, so a digest survives the next call's updates;
* ``lax.while_loop`` becomes a Python loop whose condition is read back
  to the host once per iteration (exact: the loop stops where the
  reference's does). The insert rounds of the store and the bounded
  drain do the same;
* the segmented OR of the resolution sweep (``lax.associative_scan``)
  becomes a per-parent OR: the 64 Γ bits are unpacked, reduced with a
  scatter-amax per parent, and repacked.

The Eq. 2 refinement goes through ``kernels.bitmap_refine``: the CUDA
kernel for tensors on the card, its plain version for CPU tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..kernels.bitmap_refine import (refine_bitmap_rows,
                                     refine_bitmap_rows_hier)
from ..kernels.bitops import (bit_table, bitlen32, popcount,
                              popcount_rows, to_i32, u32)
from ..kernels.ref import _and_fold
from ..patterns.store import (MASK_WORDS, PatternStore, PatternStoreBank,
                              StoreCounters, hash_insert, hash_probe,
                              masked_put_)
from ..roofline.hlo_cost import loop_condition
from .spans import Spans, maybe

N_PAD = 64              # padded query size
I32 = torch.int32
I64 = torch.int64

# Entry states of the per-slot stack (see the reference for the
# lifecycle): FREE allocatable; FRESH/LEFT pending; WAIT expanded and
# waiting on children; RES carrying a converted Γ ready to fold.
STK_FREE = 0
STK_FRESH = 1
STK_LEFT = 2
STK_WAIT = 3
STK_RES = 4


class RowSplit(NamedTuple):
    """Where a mesh step's adjacency rows lie (:func:`refine_eq2_mq` on
    a mesh): this rank holds rows ``[offset, offset + n)`` of the
    ``n_vertices``-row dense block or summary, split over mesh axis
    ``axis``; the wave's rows are divided over ``dp_axes`` (major to
    minor) for the refine."""
    mesh: object                 # torch DeviceMesh
    axis: str                    # the axis splitting the adjacency rows
    offset: int                  # this rank's first global row
    n_vertices: int              # V, the rows of the whole block
    dp_axes: tuple = ()          # axes dividing the wave's rows


class GraphArrays(NamedTuple):
    """Device view of the data graph.

    Two mutually exclusive adjacency layouts:

      * dense — ``adj_bitmap`` holds the whole packed [V, W] block and
        the hierarchical fields are None; refinement gathers rows.
      * hier  — ``adj_bitmap`` is None and the two-level layout
        (core.graph.HierBitmap) rides in ``adj_summary`` /
        ``chunk_ptr`` / ``chunk_id`` / ``chunk_data``, with ``kmax``
        its most stored chunks on a row; refinement intersects the
        summaries first and touches only live chunks.

    The scheduler picks the layout once, at construction
    (kernels.config.use_hbm_adjacency); :func:`refine_eq2_mq` branches
    on ``chunk_data is not None``.

    On a mesh (a step cell's ``fn`` on ``DTensor``s) ``split`` is set:
    ``adj_bitmap`` / ``adj_summary`` are this rank's rows of the block
    (:class:`RowSplit`), every other field whole.
    """
    adj_bitmap: torch.Tensor | None   # int32 [V, W] packed adjacency
    n_vertices: int
    adj_summary: torch.Tensor | None = None  # int32 [V, SW] chunk summary
    chunk_ptr: torch.Tensor | None = None    # int32 [V + 1] CSR over chunks
    chunk_id: torch.Tensor | None = None     # int32 [n_stored + kmax]
    chunk_data: torch.Tensor | None = None   # int32 [n_stored + kmax, C]
    kmax: int = 0                            # most stored chunks on a row
    split: RowSplit | None = None            # the rows' mesh split


class QueryBank(NamedTuple):
    """Per-slot query arrays for multi-query waves (query axis first)."""
    cand_bitmap: torch.Tensor    # int32 [S, N_PAD, W]
    nbr_mask: torch.Tensor       # bool [S, N_PAD, N_PAD]
    n_query: torch.Tensor        # int32 [S]
    learn: torch.Tensor          # bool [S] — slot stores patterns in-loop

    @staticmethod
    def empty(n_slots: int, w: int, device) -> "QueryBank":
        return QueryBank(
            cand_bitmap=torch.zeros((n_slots, N_PAD, w), dtype=I32,
                                    device=device),
            nbr_mask=torch.zeros((n_slots, N_PAD, N_PAD), dtype=torch.bool,
                                 device=device),
            n_query=torch.zeros((n_slots,), dtype=I32, device=device),
            learn=torch.zeros((n_slots,), dtype=torch.bool, device=device))


class StackBank(NamedTuple):
    """Per-slot DFS stacks held in device tensors ([S, D, ...])."""
    frontier: torch.Tensor       # int32 [S, D, N_PAD]
    used: torch.Tensor           # int32 [S, D, W]
    phi: torch.Tensor            # int32 [S, D, N_PAD + 1]
    depth: torch.Tensor          # int32 [S, D]
    cand: torch.Tensor           # int32 [S, D, W] leftover bitmap (LEFT)
    state: torch.Tensor          # int8 [S, D] STK_* lifecycle
    gamma: torch.Tensor          # int32 [S, D, MASK_WORDS] Γ* accumulator
    outstanding: torch.Tensor    # int32 [S, D] unresolved allocated children
    reported: torch.Tensor       # bool [S, D] subtree reached an embedding
    parent: torch.Tensor         # int32 [S, D] parent entry index (-1 root)
    pstack: torch.Tensor         # int32 [S, D] pending LIFO of entry indices
    ptop: torch.Tensor           # int32 [S]

    @staticmethod
    def empty(n_slots: int, depth_cap: int, w: int,
              device) -> "StackBank":
        s, d = n_slots, depth_cap

        def z(*shape, dtype=I32, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=device)
        return StackBank(
            frontier=z(s, d, N_PAD, fill=-1), used=z(s, d, w),
            phi=z(s, d, N_PAD + 1), depth=z(s, d), cand=z(s, d, w),
            state=z(s, d, dtype=torch.int8),
            gamma=z(s, d, MASK_WORDS), outstanding=z(s, d),
            reported=z(s, d, dtype=torch.bool), parent=z(s, d, fill=-1),
            pstack=z(s, d), ptop=z(s))


class DeviceResult(NamedTuple):
    """Per-slot scalar digest of one device-resident dispatch (plus the
    embedding batch); ``tb``/``sb`` are the banks, updated in place."""
    tb: PatternStoreBank
    sb: StackBank
    d_accepted: torch.Tensor     # int32 [S] admitted root rows
    d_expanded: torch.Tensor     # int32 [S] rows expanded (selected)
    d_rows: torch.Tensor         # int32 [S] child rows allocated
    d_prunes: torch.Tensor       # int32 [S] Δ dead-end prunes
    d_inj: torch.Tensor          # int32 [S] injectivity kills
    d_stored: torch.Tensor       # int32 [S] patterns stored (L1 + L4)
    d_pending: torch.Tensor      # int32 [S] pending LIFO size after
    d_live: torch.Tensor         # int32 [S] non-FREE entries after
    d_outsum: torch.Tensor       # int32 [S] sum of live entries' outstanding
    d_childlive: torch.Tensor    # int32 [S] live entries with a parent
    pat_stored: torch.Tensor     # int32 [S] Δ insert counters
    pat_overwrites: torch.Tensor
    pat_evictions: torch.Tensor
    pat_dropped: torch.Tensor
    emb_frontier: torch.Tensor   # int32 [emb_cap, N_PAD]
    emb_slot: torch.Tensor       # int32 [emb_cap]
    n_emb: torch.Tensor          # int32 scalar
    n_ids: torch.Tensor          # int32 scalar fresh embedding ids consumed


# ===================================================================
# mask helpers (int32 words; bit i of position p lives in word p // 32)
# ===================================================================
@functools.lru_cache(maxsize=None)
def _bits(device: torch.device) -> torch.Tensor:
    return bit_table(device)


def _position_bits(p: torch.Tensor) -> torch.Tensor:
    """Order positions [F] -> int32 [F, MASK_WORDS] one-hot bits."""
    word = p // 32
    bit = _bits(p.device)[p % 32]
    sel = torch.arange(MASK_WORDS, device=p.device)[None, :] == word[:, None]
    return torch.where(sel, bit[:, None], 0).to(I32)


def _below_bits_rows(d: torch.Tensor) -> torch.Tensor:
    """Positions strictly below d, rowwise: [F] -> int32 [F, MW]."""
    one = torch.ones((), dtype=I64, device=d.device)
    lo = (one << d.to(I64).clamp(0, 32)) - 1
    hi = (one << (d.to(I64) - 32).clamp(0, 32)) - 1
    return to_i32(torch.stack([lo, hi], dim=1))


def _pack_mask_rows(bits: torch.Tensor) -> torch.Tensor:
    """bool [F, 32 * MW] position sets -> packed int32 [F, MW]."""
    weights = torch.ones((), dtype=I64, device=bits.device) << torch.arange(
        32, device=bits.device)
    return to_i32((bits.reshape(-1, MASK_WORDS, 32).to(I64)
                   * weights).sum(dim=-1))


def _unpack_mask_rows(words: torch.Tensor) -> torch.Tensor:
    """int32 [F, MW] -> int32 0/1 [F, 32 * MW]."""
    shifts = torch.arange(32, dtype=I32, device=words.device)
    return ((words[:, :, None] >> shifts) & 1).reshape(words.shape[0], -1)


def _mask_bitlen(words: torch.Tensor) -> torch.Tensor:
    """Bit length of packed 64-bit masks, int32 [F, 2] -> int64 [F]
    (the paper's μ: highest Γ position below the key + 1)."""
    hi, lo = words[:, 1], words[:, 0]
    return torch.where(hi != 0, 32 + bitlen32(hi), bitlen32(lo)).to(I64)


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR over ``dim`` (pairwise folds; torch has no OR-reduce)."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])], 0)
        half = x.shape[0] // 2
        x = x[:half] | x[half:]
    return x[0]


def _extract_topk_packed(live: torch.Tensor, kpr: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``kpr`` lowest set bits per row of a packed bitmap.

    Same result as the reference's kpr-step lowest-bit loop, computed in
    one pass: per-word popcounts and their running sum locate the word
    holding the k-th set bit (a batched ``searchsorted``), and a cumsum
    over that word's 32 bits locates the bit.

    Returns (child_v int64 [F, kpr] ascending with -1 padding,
             leftover int32 [F, W], n_leftover int32 [F]).
    """
    f, w = live.shape
    dev = live.device
    pc = popcount(live).to(I64)                              # [F, W]
    cum = torch.cumsum(pc, dim=1)
    ks = torch.arange(kpr, device=dev).expand(f, kpr)
    wi = torch.searchsorted(cum, (ks + 1).contiguous())      # first cum>=k+1
    have = ks < cum[:, -1:]
    wi = wi.clamp(0, w - 1)
    rank = ks - (cum.gather(1, wi) - pc.gather(1, wi))       # rank in word
    word = live.gather(1, wi)                                # [F, kpr]
    shifts = torch.arange(32, device=dev)
    bits = (word[:, :, None] >> shifts) & 1                  # [F, kpr, 32]
    hit = (torch.cumsum(bits, dim=2) == (rank + 1)[:, :, None]) & (bits > 0)
    b = torch.argmax(hit.to(I32), dim=2)
    child = torch.where(have, wi * 32 + b, -1)
    taken = torch.zeros((f, w), dtype=I32, device=dev)
    rows = torch.arange(f, device=dev)[:, None].expand(f, kpr)
    # distinct bits of one word never carry, so add == or
    taken.index_put_((rows, wi), torch.where(have, _bits(dev)[b], 0)
                     .to(I32), accumulate=True)
    leftover = live & ~taken
    return child, leftover, popcount_rows(leftover)


# ===================================================================
# slot management
# ===================================================================
def load_slots(qb: QueryBank, tb: PatternStoreBank, slots: torch.Tensor,
               cand_bitmap: torch.Tensor, nbr_mask: torch.Tensor,
               n_query: torch.Tensor, store: PatternStore,
               learn: torch.Tensor) -> tuple[QueryBank, PatternStoreBank]:
    """Install ``k`` queries (and their initial Δ stores) in bank slots
    ``slots`` [k] in place. Row arguments carry a leading [k] axis."""
    qb.cand_bitmap[slots] = cand_bitmap
    qb.nbr_mask[slots] = nbr_mask
    qb.n_query[slots] = n_query
    qb.learn[slots] = learn
    for lane, val in zip(tb, store):
        lane[slots] = val
    return qb, tb


def load_slot(qb: QueryBank, tb: PatternStoreBank, slot: int,
              cand_bitmap: torch.Tensor, nbr_mask: torch.Tensor,
              n_query: int, store: PatternStore, learn: bool = True
              ) -> tuple[QueryBank, PatternStoreBank]:
    """One-slot :func:`load_slots`."""
    qb.cand_bitmap[slot] = cand_bitmap
    qb.nbr_mask[slot] = nbr_mask
    qb.n_query[slot] = n_query
    qb.learn[slot] = learn
    for lane, val in zip(tb, store):
        lane[slot] = val
    return qb, tb


def read_store_slot(tb: PatternStoreBank, slot: int) -> PatternStore:
    """A snapshot (copies) of one slot's Δ store — the bank keeps
    changing in place after this returns."""
    return PatternStore(*(lane[slot].clone() for lane in tb))


def clear_slot_stack(sb: StackBank, slot: int) -> StackBank:
    """Release every entry of one slot, in place (state and top pointer
    only; FREE entries' payload lanes are rewritten on allocation)."""
    sb.state[slot] = STK_FREE
    sb.ptop[slot] = 0
    return sb


def clear_slot_stacks(sb: StackBank, slots: list[int]) -> StackBank:
    """:func:`clear_slot_stack` for several slots."""
    idx = torch.as_tensor(slots, dtype=I64, device=sb.state.device)
    sb.state[idx] = STK_FREE
    sb.ptop[idx] = 0
    return sb


# ===================================================================
# expansion pieces
# ===================================================================
def refine_eq2_mq(g: GraphArrays, qb: QueryBank, query_slot: torch.Tensor,
                  frontier: torch.Tensor, depth: torch.Tensor
                  ) -> torch.Tensor:
    """Eq. 2 candidate refinement for a mixed-query wave:
    C'(row) = cand[qid, depth] ∩ ⋂_{p < depth, p ~q depth} N(frontier[p]).
    Returns the packed candidates int32 [F, W]. The adjacency layout of
    ``g`` picks the dense or the hierarchical refine."""
    d = depth.clamp(0, N_PAD - 1)
    acc0 = qb.cand_bitmap[query_slot, d]                     # [F, W]
    pos = torch.arange(N_PAD, device=depth.device)
    active = qb.nbr_mask[query_slot, d] & (pos[None, :] < depth[:, None])
    frontier = frontier.to(I32).contiguous()
    if g.split is not None:
        return _refine_split_rows(g, acc0, frontier, active.to(I32))
    if g.chunk_data is not None:
        return refine_bitmap_rows_hier(g.adj_summary, g.chunk_ptr,
                                       g.chunk_id, g.chunk_data, g.kmax,
                                       acc0, frontier, active.to(I32))
    return refine_bitmap_rows(g.adj_bitmap, acc0, frontier, active.to(I32))


def _axis_len(mesh, axis: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


def _refine_split_rows(g: GraphArrays, acc0: torch.Tensor,
                       frontier: torch.Tensor, active: torch.Tensor
                       ) -> torch.Tensor:
    """Eq. 2 on a mesh whose adjacency rows are split over
    ``g.split.axis`` (the dense block, or the hier summary with the
    chunk store whole on every rank).

    The wave's rows are divided over the data axes (when they divide
    ``F``): each rank refines its own rows, with the local kernel on its
    own adjacency rows. A position whose frontier vertex this rank holds
    contributes its row; any other position contributes all ones (its
    frontier lane becomes -1). A vertex past V - 1 counts as V - 1's, so
    its holder passes it on past its last local row and the kernels'
    own rule applies (the dense kernel reads that row; the hier kernel
    ANDs its summary and no chunk). The partial words are gathered over
    the split axis and ANDed, then the rows gathered over the data axes
    in row order: every rank returns the whole [F, W] result."""
    from ..models.layers import all_gather
    sp = g.split
    mesh = sp.mesh
    f = acc0.shape[0]
    n_dp = 1
    for a in sp.dp_axes:
        n_dp *= _axis_len(mesh, a)
    dp_axes = sp.dp_axes if f % n_dp == 0 else ()
    if dp_axes:
        k = 0
        for a in dp_axes:
            k = k * _axis_len(mesh, a) + mesh.get_local_rank(a)
        rows = slice(k * (f // n_dp), (k + 1) * (f // n_dp))
        acc0, frontier, active = acc0[rows], frontier[rows], active[rows]
    hier = g.chunk_data is not None
    table = g.adj_summary if hier else g.adj_bitmap
    lo, n_local = sp.offset, table.shape[0]
    vert = frontier.clamp(max=sp.n_vertices - 1)
    mine = (frontier >= 0) & (vert >= lo) & (vert < lo + n_local)
    local_f = torch.where(mine, frontier - lo, -1).contiguous()
    local_a = torch.where(mine, active, 0).contiguous()
    if hier:
        part = refine_bitmap_rows_hier(
            table, g.chunk_ptr[lo:lo + n_local + 1], g.chunk_id,
            g.chunk_data, g.kmax, acc0, local_f, local_a)
    else:
        part = refine_bitmap_rows(table, acc0, local_f, local_a)
    m = _axis_len(mesh, sp.axis)
    out = _and_fold(all_gather(part, mesh, sp.axis, 0).reshape(
        (m,) + tuple(part.shape)).transpose(0, 1))
    for a in reversed(dp_axes):
        out = all_gather(out, mesh, a, 0)
    return out


def deadend_lookup_children_mq(tb: PatternStoreBank, phi: torch.Tensor,
                               query_slot: torch.Tensor, depth: torch.Tensor,
                               child_v: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Paper-Eq. 7 check of the extracted children ``child_v`` [F, KPR]
    (-1 = empty). Returns (prune bool [F, KPR], Γ* contribution int32
    [F, MASK_WORDS]); the matched entries' hit counters are bumped in
    ``tb`` in place."""
    f, kpr = child_v.shape
    cv = child_v.clamp(min=0).reshape(-1)
    sl = query_slot[:, None].expand(f, kpr).reshape(-1)
    kp = depth[:, None].expand(f, kpr).reshape(-1)
    found, phi_g, mu_g, mask_g, idx = hash_probe(tb, sl, kp, cv)
    valid_g = found.reshape(f, kpr) & (child_v >= 0)
    my_phi = phi.gather(1, mu_g.reshape(f, kpr).to(I64).clamp(
        0, phi.shape[1] - 1))
    prune = valid_g & (my_phi == phi_g.reshape(f, kpr))
    masks = mask_g.reshape(f, kpr, MASK_WORDS)
    masks = torch.where(prune[:, :, None],
                        masks | _position_bits(depth)[:, None, :], 0)
    contrib = _or_reduce(masks, 1)                           # [F, MW]
    pr = prune.reshape(-1)
    tb.hits.index_put_((torch.where(pr, sl, 0), idx), pr.to(I32),
                       accumulate=True)
    return prune, contrib


def store_patterns_mq(tb: PatternStoreBank, query_slot, key_pos, key_v,
                      phis, mus, masks, valid
                      ) -> tuple[PatternStoreBank, StoreCounters]:
    """Batched Δ[slot, (u_k, v)] <- (φ, μ, Γ) hashed insert (Eq. 6),
    in place."""
    return hash_insert(tb, query_slot, key_pos, key_v, phis, mus, masks,
                       valid)


def _injectivity_mask(refined: torch.Tensor, frontier: torch.Tensor,
                      depth: torch.Tensor, rows: torch.Tensor
                      ) -> torch.Tensor:
    """Lemma-2 Γ* terms: bit(p) | bit(depth) for every mapped position
    p < depth whose vertex is a refined candidate of its row (``rows``
    masks the rows that count) -> int32 [F, MASK_WORDS]. Position bits
    are disjoint across p, so the OR-fold is an exact integer sum."""
    pos = torch.arange(N_PAD, device=refined.device)
    verts = frontier.to(I64).clamp(min=0)                    # [F, NP]
    words = refined.gather(1, verts // 32)
    hit = ((words >> (verts % 32)) & 1) > 0
    hit &= (pos[None, :] < depth[:, None]) & rows[:, None]
    posb = u32(_position_bits(pos))                          # [NP, MW]
    mask = to_i32((hit[:, :, None].to(I64) * posb[None]).sum(1))
    return mask | torch.where(hit.any(dim=1)[:, None],
                              _position_bits(depth), 0)


# ===================================================================
# host-scheduled wave programs (single step, leftover pass, megastep)
# ===================================================================
class WaveResultMQ(NamedTuple):
    """Multi-query wave result — per-row counters so the host can
    attribute prune/injectivity statistics to the owning query."""
    refined_empty: torch.Tensor  # bool [F]
    n_children: torch.Tensor     # int32 [F]
    n_leftover: torch.Tensor     # int32 [F]
    partial_mask: torch.Tensor   # int32 [F, MASK_WORDS]
    child_v: torch.Tensor        # int64 [F, KPR] (-1 where not a child)
    child_valid: torch.Tensor    # bool [F, KPR]
    leftover: torch.Tensor       # int32 [F, W]
    n_pruned: torch.Tensor       # int64 [F] dead-end prunes per row
    n_inj: torch.Tensor          # int32 [F] injectivity kills per row
    pruned_v: torch.Tensor       # int64 [F, KPR] Δ-pruned children (-1 pad)


def expand_wave_mq(g: GraphArrays, qb: QueryBank, tb: PatternStoreBank,
                   frontier: torch.Tensor, used: torch.Tensor,
                   phi: torch.Tensor, row_valid: torch.Tensor,
                   query_slot: torch.Tensor, depth: torch.Tensor,
                   kpr: int = 16) -> WaveResultMQ:
    """Expand every row of a mixed-query wave by one query position:
    Eq. 2 refinement, injectivity Γ* terms, packed top-kpr child
    extraction and the Eq. 7 dead-end check on the extracted children.
    The matched Δ entries' hit counters are bumped in ``tb`` in place."""
    query_slot, depth = query_slot.to(I64), depth.to(I64)
    refined = refine_eq2_mq(g, qb, query_slot, frontier, depth)
    refined = torch.where(row_valid[:, None], refined, 0)
    refined_empty = (popcount_rows(refined) == 0) & row_valid
    n_inj = popcount_rows(refined & used)
    inj_mask = _injectivity_mask(refined, frontier, depth, row_valid)
    child_v, leftover, n_leftover = _extract_topk_packed(refined & ~used,
                                                         kpr)
    prune, prune_mask = deadend_lookup_children_mq(tb, phi, query_slot,
                                                   depth, child_v)
    child_valid = (child_v >= 0) & ~prune
    return WaveResultMQ(
        refined_empty=refined_empty,
        n_children=child_valid.sum(dim=1, dtype=I32),
        n_leftover=n_leftover, partial_mask=inj_mask | prune_mask,
        child_v=torch.where(child_valid, child_v, -1),
        child_valid=child_valid, leftover=leftover,
        n_pruned=torch.where(row_valid, prune.sum(dim=1), 0),
        n_inj=torch.where(row_valid, n_inj, 0),
        pruned_v=torch.where(prune & row_valid[:, None], child_v, -1))


def extract_more_mq(tb: PatternStoreBank, phi: torch.Tensor,
                    query_slot: torch.Tensor, depth: torch.Tensor,
                    leftover: torch.Tensor, kpr: int = 64) -> tuple:
    """Extract up to ``kpr`` more children per row from leftover bitmaps
    (the dead-end check runs at extraction time; hit counters bumped in
    place). Returns (child_v, child_valid, new_leftover, n_leftover,
    partial_mask, n_pruned [F], pruned_v [F, KPR])."""
    query_slot, depth = query_slot.to(I64), depth.to(I64)
    child_v, new_leftover, n_leftover = _extract_topk_packed(leftover, kpr)
    prune, prune_mask = deadend_lookup_children_mq(tb, phi, query_slot,
                                                   depth, child_v)
    child_valid = (child_v >= 0) & ~prune
    return (torch.where(child_valid, child_v, -1), child_valid,
            new_leftover, n_leftover, prune_mask, prune.sum(dim=1),
            torch.where(prune, child_v, -1))


def assemble_children_mq(frontier: torch.Tensor, used: torch.Tensor,
                         phi: torch.Tensor, child_v: torch.Tensor,
                         child_valid: torch.Tensor, depth: torch.Tensor,
                         id_base: int) -> tuple:
    """Materialize child rows [F*KPR, ...] of a wave result: (frontier,
    used, phi, parent row, valid), padded flat; fresh embedding ids are
    drawn in order from ``id_base``."""
    f, kpr = child_v.shape
    dev = child_v.device
    flat_v = child_v.reshape(-1).to(I64)
    valid = child_valid.reshape(-1)
    parent = torch.arange(f, device=dev).repeat_interleave(kpr)
    d_par = depth.to(I64)[parent]
    cf = torch.where((torch.arange(N_PAD, device=dev)[None, :]
                      == d_par[:, None]) & valid[:, None],
                     flat_v[:, None], frontier[parent]).to(I32)
    vv = flat_v.clamp(min=0)
    add = torch.zeros((f * kpr, used.shape[1]), dtype=I32, device=dev)
    add[torch.arange(f * kpr, device=dev), vv // 32] = torch.where(
        valid, _bits(dev)[vv % 32], 0).to(I32)
    new_ids = int(id_base) + torch.cumsum(valid.to(I64), 0) - 1
    cp = torch.where((torch.arange(N_PAD + 1, device=dev)[None, :]
                      == d_par[:, None] + 1) & valid[:, None],
                     new_ids[:, None], phi[parent]).to(I32)
    return cf, used[parent] | add, cp, parent.to(I32), valid


class MegaResult(NamedTuple):
    """Digest of one K-depth host-scheduled megastep (ring buffer rows
    [0, F) are the input wave, [F, tail) were created in-loop; rows
    [0, head) were expanded, [head, tail) are returned pending). All
    tensors are fresh per call; ``tb`` is the bank, updated in place."""
    tb: PatternStoreBank
    buf_frontier: torch.Tensor   # int32 [C, N_PAD]
    buf_used: torch.Tensor       # int32 [C, W]
    buf_phi: torch.Tensor        # int32 [C, N_PAD + 1]
    buf_slot: torch.Tensor       # int32 [C]
    buf_depth: torch.Tensor      # int32 [C]
    buf_parent: torch.Tensor     # int32 [C] ring index of parent (-1: input)
    buf_valid: torch.Tensor      # bool [C]
    head: torch.Tensor           # int32 — rows [0, head) were expanded
    tail: torch.Tensor           # int32 — rows [head, tail) pending
    refined_empty: torch.Tensor  # bool [C] Lemma-1 dead (Eq. 2 empty)
    n_children: torch.Tensor     # int32 [C] surviving children appended
    n_leftover: torch.Tensor     # int32 [C]
    leftover: torch.Tensor       # int32 [C, W]
    partial_mask: torch.Tensor   # int32 [C, MASK_WORDS] inj+prune Γ* terms
    n_pruned: torch.Tensor       # int32 [C]
    n_inj: torch.Tensor          # int32 [C]
    n_emb_row: torch.Tensor      # int32 [C] embeddings emitted by the row
    dev_stored: torch.Tensor     # bool [C] Lemma-1 pattern stored in-loop
    pruned_v: torch.Tensor       # int32 [C, KPR] Δ-pruned children (-1 pad)
    slot_rows: torch.Tensor      # int32 [S] rows expanded per slot
    slot_children: torch.Tensor  # int32 [S] rows+embeddings created per slot
    pat_stored: torch.Tensor     # int32 [S] Δ insert counters
    pat_overwrites: torch.Tensor
    pat_evictions: torch.Tensor
    pat_dropped: torch.Tensor
    emb_frontier: torch.Tensor   # int32 [emb_cap, N_PAD]
    emb_slot: torch.Tensor       # int32 [emb_cap]
    n_emb: torch.Tensor          # int32
    n_ids: torch.Tensor          # int32 fresh embedding ids consumed


def run_megastep_mq(g: GraphArrays, qb: QueryBank, tb: PatternStoreBank,
                    frontier: torch.Tensor, used: torch.Tensor,
                    phi: torch.Tensor, row_valid: torch.Tensor,
                    query_slot: torch.Tensor, depth: torch.Tensor,
                    st_slot, st_kpos, st_kv, st_phi, st_mu, st_mask,
                    st_valid, id_base: int, learn_enabled: bool,
                    kpr: int = 8, k_depth: int = 4, capacity: int = 1024,
                    emb_cap: int = 512,
                    spans: Spans | None = None) -> MegaResult:
    """Fused expand → assemble → pattern-store over up to ``k_depth``
    consecutive depth-steps of a host-packed wave (see the reference for
    the ring-buffer design). The host's batched pattern flush (``st_*``)
    is applied first. Each iteration expands the F-row chunk at the
    head, appends surviving non-last children at the tail, emits
    last-level children as embeddings and stores Lemma-1 patterns
    in-loop. The chunk's appended-row and embedding counts are read
    back once per iteration (a ``readback`` span of ``spans``, which
    also counts the ``iterations``), so head, tail and the loop
    condition are host integers — the reference's stopping point
    exactly."""
    f_step, w = used.shape
    c = capacity
    if c < f_step * (kpr + 1) or emb_cap < f_step * kpr:
        raise ValueError("ring or embedding buffer cannot hold one chunk")
    dev = used.device
    n_slots = qb.n_query.shape[0]
    query_slot, depth = query_slot.to(I64), depth.to(I64)

    tb, pat = store_patterns_mq(tb, st_slot.to(I64), st_kpos, st_kv,
                                st_phi, st_mu, st_mask, st_valid)

    # one dump row past the end of every scattered buffer takes the
    # masked-out rows
    def ring(shape, fill, dtype=I32):
        return torch.full((c + 1,) + shape, fill, dtype=dtype, device=dev)
    buf_frontier = ring((N_PAD,), -1)
    buf_used = ring((w,), 0)
    buf_phi = ring((N_PAD + 1,), 0)
    buf_slot = ring((), 0, I64)
    buf_depth = ring((), 0, I64)
    buf_parent = ring((), -1, I64)
    buf_valid = ring((), False, torch.bool)
    buf_frontier[:f_step] = frontier
    buf_used[:f_step] = used
    buf_phi[:f_step] = phi
    buf_slot[:f_step] = query_slot
    buf_depth[:f_step] = depth
    buf_valid[:f_step] = row_valid

    zi = torch.zeros((c,), dtype=I32, device=dev)
    refined_empty = torch.zeros((c,), dtype=torch.bool, device=dev)
    dev_stored = torch.zeros((c,), dtype=torch.bool, device=dev)
    n_children, n_leftover, n_pruned = zi.clone(), zi.clone(), zi.clone()
    n_inj, n_emb_row = zi.clone(), zi.clone()
    leftover_l = torch.zeros((c, w), dtype=I32, device=dev)
    partial_l = torch.zeros((c, MASK_WORDS), dtype=I32, device=dev)
    pruned_l = torch.full((c, kpr), -1, dtype=I32, device=dev)
    slot_rows = torch.zeros((n_slots,), dtype=I32, device=dev)
    slot_children = torch.zeros((n_slots,), dtype=I32, device=dev)
    emb_frontier = torch.full((emb_cap + 1, N_PAD), -1, dtype=I32,
                              device=dev)
    emb_slot = torch.zeros((emb_cap + 1,), dtype=I32, device=dev)

    pos = torch.arange(N_PAD, device=dev)
    pos_phi = torch.arange(N_PAD + 1, device=dev)
    rows_f = torch.arange(f_step, device=dev)
    parent_local = rows_f.repeat_interleave(kpr)
    head, tail, it, n_emb, id_ctr = 0, f_step, 0, 0, int(id_base)
    while (head < tail and it < k_depth and tail + f_step * kpr <= c
           and n_emb + f_step * kpr <= emb_cap):
        chunk = slice(head, head + f_step)
        cf, cu, cp = buf_frontier[chunk], buf_used[chunk], buf_phi[chunk]
        slot_c, depth_c = buf_slot[chunk], buf_depth[chunk]
        valid_c = (rows_f + head < tail) & buf_valid[chunk]

        res = expand_wave_mq(g, qb, tb, cf, cu, cp, valid_c, slot_c,
                             depth_c, kpr)
        is_last = depth_c + 1 == qb.n_query[slot_c]          # [F]

        # ---- materialize all surviving children (flat) -----------------
        flat_v = res.child_v.reshape(-1)
        cvalid_flat = res.child_valid.reshape(-1)
        d_par = depth_c[parent_local]
        slot_flat = slot_c[parent_local]
        cf2 = torch.where((pos[None, :] == d_par[:, None])
                          & cvalid_flat[:, None], flat_v[:, None],
                          cf[parent_local]).to(I32)
        vv = flat_v.clamp(min=0)
        add = torch.zeros((f_step * kpr, w), dtype=I32, device=dev)
        add[torch.arange(f_step * kpr, device=dev), vv // 32] = torch.where(
            cvalid_flat, _bits(dev)[vv % 32], 0).to(I32)
        cu2 = cu[parent_local] | add

        # ---- embeddings: last-level children go to the emb buffer ------
        last_flat = is_last[parent_local]
        emb_valid = cvalid_flat & last_flat
        emb_off = torch.cumsum(emb_valid.to(I64), 0) - 1
        emb_idx = torch.where(emb_valid, n_emb + emb_off, emb_cap)
        emb_frontier[emb_idx] = cf2
        emb_slot[emb_idx] = slot_flat.to(I32)
        n_emb_row_c = (res.child_valid & is_last[:, None]).sum(dim=1)

        # ---- append non-last children at the tail ----------------------
        app_valid = cvalid_flat & ~last_flat
        app_off = torch.cumsum(app_valid.to(I64), 0) - 1
        app_idx = torch.where(app_valid, tail + app_off, c)
        cp2 = torch.where((pos_phi[None, :] == d_par[:, None] + 1)
                          & app_valid[:, None], id_ctr + app_off[:, None],
                          cp[parent_local]).to(I32)
        buf_frontier[app_idx] = cf2
        buf_used[app_idx] = cu2
        buf_phi[app_idx] = cp2
        buf_slot[app_idx] = slot_flat
        buf_depth[app_idx] = d_par + 1
        buf_parent[app_idx] = head + parent_local
        buf_valid[app_idx] = True
        n_child_c = (res.child_valid & ~is_last[:, None]).sum(dim=1)

        # ---- in-loop Lemma-1 stores (Eq. 2 came back empty) ------------
        do_store = (res.refined_empty & (depth_c >= 1) & qb.learn[slot_c]
                    & learn_enabled)
        qnbr = _pack_mask_rows(qb.nbr_mask[slot_c,
                                           depth_c.clamp(0, N_PAD - 1)])
        gamma_w = qnbr & _below_bits_rows(depth_c)
        key_pos = (depth_c - 1).clamp(min=0)
        key_v = cf.gather(1, key_pos[:, None])[:, 0]
        mu = _mask_bitlen(gamma_w & _below_bits_rows(key_pos))
        phi_id = cp.gather(1, mu[:, None])[:, 0]
        tb, pat_c = store_patterns_mq(tb, slot_c, key_pos.to(I32), key_v,
                                      phi_id, mu.to(I32), gamma_w, do_store)
        pat = pat.add(pat_c)

        # ---- digest lanes for this chunk -------------------------------
        m = valid_c
        refined_empty[chunk] = res.refined_empty
        n_children[chunk] = torch.where(m, n_child_c, 0).to(I32)
        n_leftover[chunk] = torch.where(m, res.n_leftover, 0)
        leftover_l[chunk] = torch.where(m[:, None], res.leftover, 0)
        partial_l[chunk] = torch.where(m[:, None], res.partial_mask, 0)
        n_pruned[chunk] = torch.where(m, res.n_pruned, 0).to(I32)
        n_inj[chunk] = torch.where(m, res.n_inj, 0)
        n_emb_row[chunk] = torch.where(m, n_emb_row_c, 0).to(I32)
        dev_stored[chunk] = m & do_store
        pruned_l[chunk] = torch.where(m[:, None], res.pruned_v, -1).to(I32)
        slot_rows.index_put_((slot_c,), m.to(I32), accumulate=True)
        slot_children.index_put_(
            (slot_c,), torch.where(m, n_child_c + n_emb_row_c, 0).to(I32),
            accumulate=True)

        with maybe(spans, "readback"):
            n_new, n_emb_new = torch.stack([app_valid.sum(),
                                            emb_valid.sum()]).tolist()
        if spans is not None:
            spans.count("iterations")
        head = min(head + f_step, tail)
        tail += n_new
        it += 1
        n_emb += n_emb_new
        id_ctr += n_new

    def i32(x):
        return torch.tensor(x, dtype=I32, device=dev)
    return MegaResult(
        tb=tb, buf_frontier=buf_frontier[:c], buf_used=buf_used[:c],
        buf_phi=buf_phi[:c], buf_slot=buf_slot[:c].to(I32),
        buf_depth=buf_depth[:c].to(I32), buf_parent=buf_parent[:c].to(I32),
        buf_valid=buf_valid[:c], head=i32(head), tail=i32(tail),
        refined_empty=refined_empty, n_children=n_children,
        n_leftover=n_leftover, leftover=leftover_l,
        partial_mask=partial_l, n_pruned=n_pruned, n_inj=n_inj,
        n_emb_row=n_emb_row, dev_stored=dev_stored, pruned_v=pruned_l,
        slot_rows=slot_rows, slot_children=slot_children,
        pat_stored=pat.stored, pat_overwrites=pat.overwrites,
        pat_evictions=pat.evictions, pat_dropped=pat.dropped,
        emb_frontier=emb_frontier[:emb_cap], emb_slot=emb_slot[:emb_cap],
        n_emb=i32(n_emb), n_ids=i32(id_ctr - int(id_base)))


# ===================================================================
# device-resident scheduler loop
# ===================================================================
def _slot_counts(sel_slot: torch.Tensor, valid: torch.Tensor, n_slots: int,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Per-slot sum of ``weights`` (default 1) over valid rows -> int64."""
    tgt = torch.where(valid, sel_slot.to(I64), n_slots)
    w = (valid.to(I64) if weights is None
         else torch.where(valid, weights.to(I64), 0))
    out = torch.zeros((n_slots + 1,), dtype=I64, device=valid.device)
    out.index_put_((tgt,), w, accumulate=True)
    return out[:n_slots]


def _group_rank(slot: torch.Tensor, valid: torch.Tensor, n_slots: int
                ) -> torch.Tensor:
    """Rank of each valid element within its slot group (valid elements
    grouped by slot in ascending order), via a scatter-min of the first
    global index."""
    gidx = torch.cumsum(valid.to(I64), dim=0) - 1
    start = torch.full((n_slots + 1,), 2**30, dtype=I64, device=valid.device)
    start.scatter_reduce_(0, torch.where(valid, slot.to(I64), n_slots),
                          gidx, "amin")
    return torch.where(valid, gidx - start[slot.to(I64).clamp(0, n_slots)],
                       0)


def _select_set_bits(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``k`` set entries of bool [n] ``mask``,
    ascending (``n`` where exhausted) -> int64 [k]."""
    csum = torch.cumsum(mask.to(I64), dim=0)
    ks = torch.arange(1, k + 1, dtype=I64, device=mask.device)
    return torch.searchsorted(csum, ks, side="left")


def _free_entry_order(isfree: torch.Tensor) -> torch.Tensor:
    """``eor[s, r]`` = entry id of the r-th free entry of slot ``s``
    (``d_cap`` when exhausted) -> int64 [S, D]."""
    s, d_cap = isfree.shape
    frank = torch.cumsum(isfree.to(I64), dim=1)
    ks = torch.arange(1, d_cap + 1, dtype=I64, device=isfree.device)
    return torch.searchsorted(frank, ks.expand(s, d_cap).contiguous(),
                              side="left")


def _resolution_sweep(qb: QueryBank, tb: PatternStoreBank, sb: StackBank,
                      learn_enabled: bool, batch: int
                      ) -> tuple[torch.Tensor, StoreCounters]:
    """One Lemma-4 resolution pass over every slot's stack, in place.

    Phase A folds every resolved (RES) child — at most ``2 * batch`` per
    sweep — into its parent (Γ |= child Γ unless the child reported,
    outstanding -= count, child freed; RES roots are freed). Phase B
    finalizes up to ``batch`` subtree-exhausted WAIT entries: the
    μ == 0 / μ > 0 conversion, the Δ store, and the entry turns RES.

    Returns (per-slot stores int64 [S], insert counters).
    """
    s_dim, d_dim = sb.state.shape
    n_flat = s_dim * d_dim
    dev = sb.state.device
    state, par = sb.state, sb.parent

    # ---- phase A: fold resolved children into their parents ------------
    res_m = state == STK_RES
    res_child = res_m & (par >= 0)
    child_i = _select_set_bits(res_child.reshape(-1), 2 * batch)
    valid_c = child_i < n_flat
    ci = child_i.clamp(0, n_flat - 1)
    rep_flat = sb.reported.reshape(-1)
    gam_flat = sb.gamma.reshape(n_flat, MASK_WORDS)
    s_grid = torch.arange(s_dim, device=dev)[:, None] * d_dim
    pgid_all = (s_grid + par.to(I64)).reshape(-1)
    pg = torch.where(valid_c, pgid_all[ci], n_flat)          # n_flat: dump
    crep = rep_flat[ci]

    cnt = torch.zeros((n_flat + 1,), dtype=I32, device=dev)
    cnt.index_put_((pg,), torch.ones_like(pg, dtype=I32), accumulate=True)
    rep_fold = torch.zeros((n_flat + 1,), dtype=I32, device=dev)
    rep_fold.index_put_((pg,), crep.to(I32), accumulate=True)
    # per-parent OR of the children's Γ (a reported child folds no Γ; a
    # RES parent never has RES children, so the fold is race-free)
    gs = torch.where((valid_c & ~crep)[:, None], gam_flat[ci], 0)
    bits = _unpack_mask_rows(gs)                             # [B, 64]
    orb = torch.zeros((n_flat + 1, bits.shape[1]), dtype=I32, device=dev)
    orb.scatter_reduce_(0, pg[:, None].expand_as(bits).contiguous(), bits,
                        "amax")
    contrib = _pack_mask_rows(orb[:n_flat] > 0)
    gam_flat |= contrib
    rep_flat |= rep_fold[:n_flat] > 0
    sb.outstanding.sub_(cnt[:n_flat].reshape(s_dim, d_dim))
    state_flat = state.reshape(-1)
    masked_put_(state_flat, (child_i,), STK_FREE, valid_c)
    state.masked_fill_(res_m & (par < 0), STK_FREE)

    # ---- phase B: finalize subtree-exhausted WAIT entries --------------
    fin = (state == STK_WAIT) & (sb.outstanding == 0)
    bsel = _select_set_bits(fin.reshape(-1), batch)
    valid_b = bsel < n_flat
    bclip = bsel.clamp(0, n_flat - 1)
    slot_b = torch.where(valid_b, bclip // d_dim, 0)
    ent_b = torch.where(valid_b, bclip % d_dim, 0)

    d_b = sb.depth[slot_b, ent_b].to(I64)
    gm = sb.gamma[slot_b, ent_b]                             # [B, MW]
    rep_b = sb.reported[slot_b, ent_b]
    fr_b = sb.frontier[slot_b, ent_b]
    ph_b = sb.phi[slot_b, ent_b]
    qnbr_b = _pack_mask_rows(qb.nbr_mask[slot_b, d_b.clamp(0, N_PAD - 1)])
    has_bit = ((gm & _position_bits(d_b)) != 0).any(dim=1)
    gconv = torch.where(has_bit[:, None],
                        (gm | qnbr_b) & _below_bits_rows(d_b), gm)
    key_pos = (d_b - 1).clamp(min=0)
    key_v = fr_b.gather(1, key_pos[:, None])[:, 0]
    mu = _mask_bitlen(gconv & _below_bits_rows(key_pos))
    phi_v = ph_b.gather(1, mu[:, None])[:, 0]
    do_store = (valid_b & ~rep_b & (d_b >= 1) & qb.learn[slot_b]
                & learn_enabled)
    tb, pat_c = store_patterns_mq(tb, slot_b, key_pos.to(I32), key_v,
                                  phi_v, mu.to(I32), gconv, do_store)

    masked_put_(state_flat, (bsel,), STK_RES, valid_b)
    masked_put_(sb.gamma, (slot_b, ent_b), gconv, valid_b)
    return _slot_counts(slot_b, do_store, s_dim), pat_c


def run_device_megastep(g: GraphArrays, qb: QueryBank,
                        tb: PatternStoreBank, sb: StackBank,
                        in_root: torch.Tensor, in_rid: torch.Tensor,
                        in_slot: torch.Tensor, in_valid: torch.Tensor,
                        active: torch.Tensor, id_base: int,
                        learn_enabled: bool, t_max: int,
                        kpr: int = 8, emb_cap: int = 512,
                        wave: int | None = None,
                        spans: Spans | None = None) -> DeviceResult:
    """One dispatch of the device-resident scheduler loop.

    Admits root rows into free stack entries, then runs up to ``t_max``
    repack→expand→resolve iterations on the device (see the reference
    for each step), then a drain of at most 12 resolution sweeps. ``tb``
    and ``sb`` are updated in place. ``spans``, when given, counts the
    ``iterations`` (loop iterations run, one Eq. 2 refine each) and
    takes each loop-condition read to the host as a ``readback`` span
    (its seconds include waiting for the device to finish the queued
    work).
    """
    r = in_root.shape[0]
    f = wave if wave is not None else r
    n_slots, d_cap = sb.state.shape
    w = sb.used.shape[2]
    dev = sb.state.device
    if emb_cap < f * kpr:
        raise ValueError("emb buffer cannot hold one iteration")
    f_rows = torch.arange(f, device=dev)
    a_cap = min(8 * f, f * kpr)
    bits = _bits(dev)
    pos = torch.arange(N_PAD, device=dev)
    pos_phi = torch.arange(N_PAD + 1, device=dev)
    active = active.to(dev)

    def readback(cond: torch.Tensor, first: bool) -> bool:
        with maybe(spans, "readback"):
            return loop_condition(cond, first)

    # ---- root admission: place accepted inputs into free entries -------
    in_slot = in_slot.to(I64)
    isfree = sb.state == STK_FREE
    free_n = isfree.sum(dim=1)
    n_in = _slot_counts(in_slot, in_valid, n_slots)
    accept_s = torch.where(active, torch.minimum(n_in, free_n // (kpr + 2)),
                           0)
    rank_in = _group_rank(in_slot, in_valid, n_slots)
    acc = in_valid & (rank_in < accept_s[in_slot])
    eor = _free_entry_order(isfree)
    ent_in = eor[in_slot, rank_in.clamp(0, d_cap - 1)]
    ok_in = acc & (ent_in < d_cap)
    at_in = (in_slot, ent_in)

    root_f = torch.where(pos[None, :] == 0, in_root[:, None], -1)
    rv = in_root.to(I64).clamp(min=0)
    root_u = torch.zeros((r, w), dtype=I32, device=dev)
    root_u[torch.arange(r, device=dev), rv // 32] = bits[rv % 32]
    root_p = torch.where(pos_phi[None, :] == 1, in_rid[:, None], 0)
    masked_put_(sb.frontier, at_in, root_f, ok_in)
    masked_put_(sb.used, at_in, root_u, ok_in)
    masked_put_(sb.phi, at_in, root_p, ok_in)
    masked_put_(sb.depth, at_in, 1, ok_in)
    masked_put_(sb.state, at_in, STK_FRESH, ok_in)
    masked_put_(sb.gamma, at_in, 0, ok_in)
    masked_put_(sb.outstanding, at_in, 0, ok_in)
    masked_put_(sb.reported, at_in, False, ok_in)
    masked_put_(sb.parent, at_in, -1, ok_in)
    masked_put_(sb.cand, at_in, 0, ok_in)
    push_pos = torch.where(ok_in, sb.ptop[in_slot].to(I64) + rank_in, 0)
    masked_put_(sb.pstack, (in_slot, push_pos), ent_in, ok_in)
    d_accepted = _slot_counts(in_slot, ok_in, n_slots)
    sb.ptop.add_(d_accepted.to(I32))

    zs = torch.zeros((n_slots,), dtype=I64, device=dev)
    # one dump row past the end of each embedding buffer takes the
    # masked-out rows of the scatter
    emb_frontier = torch.full((emb_cap + 1, N_PAD), -1, dtype=I32,
                              device=dev)
    emb_slot = torch.zeros((emb_cap + 1,), dtype=I32, device=dev)
    n_emb = torch.zeros((), dtype=I64, device=dev)
    id_ctr = torch.full((), int(id_base), dtype=I64, device=dev)
    pat = StoreCounters.zeros(n_slots, dev)
    d_expanded, d_rows, d_prunes, d_inj, d_stored = zs, zs, zs, zs, zs

    it = 0
    while it < t_max and readback(
            (torch.where(active, sb.ptop, 0) > 0).any()
            & (n_emb + f * kpr <= emb_cap), it == 0):
        st, ptop = sb.state, sb.ptop.to(I64)

        # ---- wave selection: waterfill quota over pending slots --------
        pend = torch.where(active, ptop, 0)
        free_now = (st == STK_FREE).sum(dim=1)
        quota_cap = (free_now // (kpr + 1)).clamp(min=1)
        desire = torch.minimum(pend, quota_cap)
        n_act = (desire > 0).sum().clamp(min=1)
        base = f // n_act
        q1 = torch.minimum(desire, base)
        want = desire - q1
        rem = f - q1.sum()
        extra = torch.minimum(want, rem - (torch.cumsum(want, 0) - want)
                              ).clamp(min=0)
        q = q1 + extra                                       # [S]
        qcum = torch.cumsum(q, 0)
        offs = qcum - q
        s_of = torch.searchsorted(qcum, f_rows, right=True)
        row_valid = f_rows < q.sum()
        s_of_c = torch.where(row_valid, s_of, 0).clamp(0, n_slots - 1)
        k_in = (f_rows - offs[s_of_c]).clamp(min=0)
        ent_sel = sb.pstack[s_of_c, (ptop[s_of_c] - 1 - k_in).clamp(
            0, d_cap - 1)].to(I64)
        e_c = torch.where(row_valid, ent_sel, 0)
        ptop2 = ptop - q
        at_sel = (s_of_c, e_c)

        wf = sb.frontier[at_sel]
        wu = sb.used[at_sel]
        wphi = sb.phi[at_sel]
        wd = sb.depth[at_sel].to(I64)
        wcand = sb.cand[at_sel]
        wg = sb.gamma[at_sel]
        w_out = sb.outstanding[at_sel]
        w_rep = sb.reported[at_sel]
        st_sel = st[at_sel]
        is_left = (st_sel == STK_LEFT) & row_valid
        is_fresh = (st_sel == STK_FRESH) & row_valid

        # ---- expansion (fresh: full Eq.2 pass; LEFT: re-extraction) ----
        refined = refine_eq2_mq(g, qb, s_of_c, wf, wd)
        refined = torch.where(is_fresh[:, None], refined, 0)
        refined_empty = is_fresh & (popcount_rows(refined) == 0)
        n_inj_row = torch.where(is_fresh, popcount_rows(refined & wu), 0)

        inj_mask = _injectivity_mask(refined, wf, wd, is_fresh)
        live = torch.where(is_left[:, None], wcand, refined & ~wu)
        child_v, leftover, n_leftover = _extract_topk_packed(live, kpr)
        prune, prune_mask = deadend_lookup_children_mq(
            tb, wphi, s_of_c, wd, child_v)
        child_valid = (child_v >= 0) & ~prune & row_valid[:, None]
        partial = torch.where(is_left[:, None], prune_mask,
                              inj_mask | prune_mask)
        n_pruned_row = torch.where(row_valid, prune.sum(dim=1), 0)

        # ---- materialize children (flat [F*kpr], slot-grouped) ---------
        parent_local = torch.arange(f * kpr, device=dev) // kpr
        flat_v = child_v.reshape(-1)
        cvalid_flat = child_valid.reshape(-1)
        d_par = wd[parent_local]
        slot_flat = s_of_c[parent_local]
        is_last = wd + 1 == qb.n_query[s_of_c]
        last_flat = is_last[parent_local]
        cf2 = torch.where((pos[None, :] == d_par[:, None])
                          & cvalid_flat[:, None], flat_v[:, None],
                          wf[parent_local]).to(I32)
        vv = flat_v.clamp(min=0)

        # ---- embeddings: last-level children, no allocation ------------
        emb_valid = cvalid_flat & last_flat
        emb_off = torch.cumsum(emb_valid.to(I64), 0) - 1
        emb_idx = torch.where(emb_valid, n_emb + emb_off, emb_cap)
        emb_frontier[emb_idx] = cf2
        emb_slot[emb_idx] = slot_flat.to(I32)
        n_emb_new = emb_valid.sum()
        n_emb_row = (child_valid & is_last[:, None]).sum(dim=1)

        # ---- allocate non-last children into free entries --------------
        eor_l = _free_entry_order(st == STK_FREE)
        app_valid = cvalid_flat & ~last_flat
        a_sel = _select_set_bits(app_valid, a_cap)           # [A]
        a_valid = a_sel < f * kpr
        a_i = a_sel.clamp(0, f * kpr - 1)
        slot_a = slot_flat[a_i]
        par_a = parent_local[a_i]
        j = _group_rank(slot_a, a_valid, n_slots)
        ent_ch = eor_l[slot_a, j.clamp(0, d_cap - 1)]
        ok = a_valid & (ent_ch < d_cap)
        alloc_flag = torch.zeros((f * kpr + 1,), dtype=torch.bool,
                                 device=dev)
        alloc_flag[torch.where(ok, a_sel, f * kpr)] = True
        alloc_flag = alloc_flag[:f * kpr]
        fail = app_valid & ~alloc_flag

        # children that found no entry fold back into the parent row's
        # leftover bitmap (distinct vertices, so add == or)
        fold = torch.zeros((f, w), dtype=I32, device=dev)
        fold.index_put_((parent_local, vv // 32),
                        torch.where(fail, bits[vv % 32], 0).to(I32),
                        accumulate=True)
        leftover = leftover | fold
        n_leftover = popcount_rows(leftover)

        child_ids = id_ctr + torch.cumsum(ok.to(I64), 0) - 1
        d_par_a = d_par[a_i]
        vv_a = vv[a_i]
        cf_a = cf2[a_i]
        add_a = torch.zeros((a_cap, w), dtype=I32, device=dev)
        add_a[torch.arange(a_cap, device=dev), vv_a // 32] = bits[vv_a % 32]
        cu_a = wu[par_a] | add_a
        cp_a = torch.where((pos_phi[None, :] == d_par_a[:, None] + 1)
                           & ok[:, None], child_ids[:, None], wphi[par_a])
        n_alloc = ok.sum()
        n_alloc_row = alloc_flag.reshape(f, kpr).sum(dim=1)
        alloc_s = _slot_counts(slot_a, ok, n_slots)

        at_a = (slot_a, ent_ch)
        masked_put_(sb.frontier, at_a, cf_a, ok)
        masked_put_(sb.used, at_a, cu_a, ok)
        masked_put_(sb.phi, at_a, cp_a, ok)
        masked_put_(sb.depth, at_a, d_par_a + 1, ok)
        masked_put_(sb.state, at_a, STK_FRESH, ok)
        masked_put_(sb.gamma, at_a, 0, ok)
        masked_put_(sb.outstanding, at_a, 0, ok)
        masked_put_(sb.reported, at_a, False, ok)
        masked_put_(sb.parent, at_a, ent_sel[par_a], ok)
        masked_put_(sb.cand, at_a, 0, ok)

        # ---- in-loop Lemma-1 stores (Eq. 2 came back empty) ------------
        do_store = (refined_empty & (wd >= 1) & qb.learn[s_of_c]
                    & learn_enabled)
        qnbr = _pack_mask_rows(qb.nbr_mask[s_of_c, wd.clamp(0, N_PAD - 1)])
        gamma_w = qnbr & _below_bits_rows(wd)
        key_pos = (wd - 1).clamp(min=0)
        key_v = wf.gather(1, key_pos[:, None])[:, 0]
        mu = _mask_bitlen(gamma_w & _below_bits_rows(key_pos))
        phi_id = wphi.gather(1, mu[:, None])[:, 0]
        tb, pat_c = store_patterns_mq(tb, s_of_c, key_pos.to(I32), key_v,
                                      phi_id, mu.to(I32), gamma_w, do_store)

        # ---- update the selected entries -------------------------------
        has_left = (n_leftover > 0) & row_valid & ~refined_empty
        new_state = torch.where(
            refined_empty, STK_RES,
            torch.where(has_left, STK_LEFT, STK_WAIT)).to(torch.int8)
        new_g = wg | partial | torch.where(refined_empty[:, None],
                                           gamma_w, 0)
        masked_put_(sb.state, at_sel, new_state, row_valid)
        masked_put_(sb.gamma, at_sel, new_g, row_valid)
        masked_put_(sb.outstanding, at_sel, w_out + n_alloc_row, row_valid)
        masked_put_(sb.reported, at_sel, w_rep | (n_emb_row > 0), row_valid)
        masked_put_(sb.cand, at_sel,
                    torch.where(has_left[:, None], leftover, 0), row_valid)

        # ---- re-queue: LEFT entries below, fresh children on top -------
        lrank = _group_rank(s_of_c, has_left, n_slots)
        lpos = torch.where(has_left, ptop2[s_of_c] + lrank, 0)
        masked_put_(sb.pstack, (s_of_c, lpos), ent_sel, has_left)
        ptop3 = ptop2 + _slot_counts(s_of_c, has_left, n_slots)
        cpos = torch.where(ok, ptop3[slot_a] + j, 0)
        masked_put_(sb.pstack, (slot_a, cpos), ent_ch, ok)
        sb.ptop.copy_(ptop3 + alloc_s)

        # ---- one resolution sweep per iteration ------------------------
        n_stored_fin, pat_f = _resolution_sweep(qb, tb, sb, learn_enabled,
                                                f)

        it += 1
        if spans is not None:
            spans.count("iterations")
        n_emb = n_emb + n_emb_new
        id_ctr = id_ctr + n_alloc
        pat = pat.add(pat_c).add(pat_f)
        d_expanded = d_expanded + _slot_counts(s_of_c, row_valid, n_slots)
        d_rows = d_rows + alloc_s
        d_prunes = d_prunes + _slot_counts(s_of_c, row_valid, n_slots,
                                           n_pruned_row)
        d_inj = d_inj + _slot_counts(s_of_c, row_valid, n_slots, n_inj_row)
        d_stored = (d_stored + n_stored_fin
                    + _slot_counts(s_of_c, do_store, n_slots))

    # ---- final drain: at most 12 more resolution sweeps ----------------
    for i in range(12):
        if not readback(((sb.state == STK_RES).any()
                         | ((sb.state == STK_WAIT)
                            & (sb.outstanding == 0)).any()), i == 0):
            break
        n_st, pat_d = _resolution_sweep(qb, tb, sb, learn_enabled, f)
        d_stored = d_stored + n_st
        pat = pat.add(pat_d)

    live_mask = sb.state != STK_FREE
    # Lemma-4 conservation lanes for the host-side digest validator
    d_outsum = torch.where(live_mask, sb.outstanding, 0).sum(dim=1)
    d_childlive = (live_mask & (sb.parent >= 0)).sum(dim=1)

    def i32(x):
        return x.to(I32)
    return DeviceResult(
        tb=tb, sb=sb,
        d_accepted=i32(d_accepted), d_expanded=i32(d_expanded),
        d_rows=i32(d_rows), d_prunes=i32(d_prunes), d_inj=i32(d_inj),
        d_stored=i32(d_stored), d_pending=sb.ptop.clone(),
        d_live=i32(live_mask.sum(dim=1)), d_outsum=i32(d_outsum),
        d_childlive=i32(d_childlive),
        pat_stored=pat.stored, pat_overwrites=pat.overwrites,
        pat_evictions=pat.evictions, pat_dropped=pat.dropped,
        emb_frontier=emb_frontier[:emb_cap], emb_slot=emb_slot[:emb_cap],
        n_emb=i32(n_emb), n_ids=i32(id_ctr - int(id_base)))
