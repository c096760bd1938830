"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each function here computes exactly what its kernel computes and is what
the wrapper runs for a CPU tensor (or with ``backend="torch"``).
"""
from __future__ import annotations

import torch

from .bitops import to_i32


def refine_bitmap_rows_ref(adj_bitmap: torch.Tensor, cand_rows: torch.Tensor,
                           frontier: torch.Tensor, active: torch.Tensor
                           ) -> torch.Tensor:
    """Per-row Eq. 2 refinement:

        out[i] = cand[i] & AND_{p: active[i,p] != 0 and frontier[i,p] >= 0}
                 adj[frontier[i, p]]

    ``adj_bitmap`` int32 [V, W], ``cand_rows`` int32 [F, W], ``frontier``
    and ``active`` int32 [F, NP]; returns int32 [F, W]. A frontier vertex
    past V - 1 reads row V - 1, as the reference kernel clamps it.

    Torch has no AND-reduction, so the gathered [F, NP, W] rows (inactive
    ones replaced by all-ones) are folded pairwise: log2(NP) ANDs.
    """
    v = adj_bitmap.shape[0]
    f, np_ = frontier.shape
    act = (active != 0) & (frontier >= 0)
    rows = adj_bitmap[frontier.clamp(0, v - 1).reshape(-1)].reshape(
        f, np_, -1)
    rows = torch.where(act[:, :, None], rows,
                       torch.full((), -1, dtype=rows.dtype,
                                  device=rows.device))
    while rows.shape[1] > 1:
        if rows.shape[1] % 2:
            rows = torch.cat([rows, torch.full_like(rows[:, :1], -1)], 1)
        half = rows.shape[1] // 2
        rows = rows[:, :half] & rows[:, half:]
    if np_ == 0:
        return cand_rows.clone()
    return cand_rows & rows[:, 0]


def _and_fold(rows: torch.Tensor) -> torch.Tensor:
    """AND-reduce int32 ``rows`` [F, K, ...] over axis 1 (pairwise:
    torch has no AND-reduction); K == 0 gives all-ones."""
    if rows.shape[1] == 0:
        return torch.full_like(rows[:, :1], -1)[:, 0]
    while rows.shape[1] > 1:
        if rows.shape[1] % 2:
            rows = torch.cat([rows, torch.full_like(rows[:, :1], -1)], 1)
        half = rows.shape[1] // 2
        rows = rows[:, :half] & rows[:, half:]
    return rows[:, 0]


def summary_intersect_ref(summary: torch.Tensor, cand_rows: torch.Tensor,
                          frontier: torch.Tensor, active: torch.Tensor,
                          chunk_words: int) -> torch.Tensor:
    """First level of the hierarchical refinement:

        sacc[i] = cand_summary[i] & AND_{p active, frontier >= 0}
                  summary[min(frontier[i, p], V - 1)]

    where bit ``c`` of ``cand_summary[i]`` is set iff any of the C words
    of chunk ``c`` of ``cand_rows[i]`` is nonzero. A chunk dead in
    ``sacc`` is zero in the dense result. Returns int32 [F, SW].
    """
    v, sw = summary.shape
    f, np_ = frontier.shape
    w = cand_rows.shape[1]
    c = int(chunk_words)
    ncp = sw * 32
    dev = cand_rows.device
    cpad = torch.zeros((f, ncp * c), dtype=torch.int32, device=dev)
    cpad[:, :w] = cand_rows
    live = (cpad.reshape(f, ncp, c) != 0).any(dim=2)
    shifts = torch.arange(32, device=dev)
    cand_sum = to_i32((live.reshape(f, sw, 32).to(torch.int64) << shifts)
                      .sum(dim=2))
    act = (active != 0) & (frontier >= 0)
    rows = summary[frontier.clamp(0, v - 1).long()]          # [F, NP, SW]
    rows = torch.where(act[:, :, None], rows,
                       torch.full((), -1, dtype=rows.dtype, device=dev))
    return cand_sum & _and_fold(rows)


def refine_bitmap_rows_hier_ref(summary: torch.Tensor,
                                chunk_ptr: torch.Tensor,
                                chunk_id: torch.Tensor,
                                chunk_data: torch.Tensor, kmax: int,
                                cand_rows: torch.Tensor,
                                frontier: torch.Tensor, active: torch.Tensor,
                                positions: int | None = None
                                ) -> torch.Tensor:
    """Eq. 2 refinement over the two-level layout (core.graph.HierBitmap).

    ``summary`` int32 [V, SW], ``chunk_ptr`` int32 [V + 1], ``chunk_id``
    int32 [P + kmax], ``chunk_data`` int32 [P + kmax, C], ``kmax`` the
    layout's most stored chunks on a row; ``cand_rows`` int32 [F, W],
    ``frontier`` / ``active`` int32 [F, NP]. Returns int32 [F, W].

    The summary intersection (:func:`summary_intersect_ref`) zeroes the
    dead chunks of ``cand``; then each active position's row, rebuilt
    from its stored chunks, is ANDed in. On frontier values in
    ``[-1, V)`` this is the dense result on the same graph. A frontier
    value past V - 1 follows the reference's hierarchical kernel: it
    ANDs ``summary[V - 1]`` and no chunk (``chunk_ptr`` is clamped at
    index V, so its chunk window is empty). The layout's summaries must
    match its store, as ``build_hier_bitmap`` makes them.

    The rebuilt row is a scatter of the ``kmax``-chunk window into
    ``ncp + 1`` chunks, the last one taking the window's padding and
    being sliced off. Positions run up to the deepest active one, read
    from the data (a host sync on the card) unless ``positions`` gives
    that bound; positions past it must be inactive.
    """
    v, sw = summary.shape
    f, np_ = frontier.shape
    w = cand_rows.shape[1]
    c = chunk_data.shape[1]
    ncp = sw * 32
    dev = cand_rows.device
    sacc = summary_intersect_ref(summary, cand_rows, frontier, active, c)
    shifts = torch.arange(32, device=dev)
    livebit = (sacc[:, :, None] >> shifts) & 1              # [F, SW, 32]
    mask = livebit.reshape(f, ncp, 1).expand(f, ncp, c).reshape(
        f, ncp * c)[:, :w]
    out = cand_rows & -mask.to(torch.int32)
    act = (active != 0) & (frontier >= 0) & (frontier < v)
    if positions is None:
        from ..roofline.hlo_cost import loop_bound
        deepest = torch.where(act.any(dim=0),
                              torch.arange(1, np_ + 1, device=dev), 0)
        positions = loop_bound(deepest.max()) if np_ else 0
    win = torch.arange(kmax, device=dev)
    for p in range(positions):
        vtx = frontier[:, p].clamp(0, v - 1).long()
        k0 = chunk_ptr[vtx].long()
        nk = chunk_ptr[vtx + 1].long() - k0
        ks = k0[:, None] + win[None, :]                      # [F, kmax]
        km = win[None, :] < nk[:, None]
        ids = torch.where(km, chunk_id[ks].long(), ncp)
        data = torch.where(km[:, :, None], chunk_data[ks], 0)
        rows = torch.zeros((f, ncp + 1, c), dtype=torch.int32, device=dev)
        rows.scatter_(1, ids[:, :, None].expand(f, kmax, c), data)
        rows = rows[:, :ncp].reshape(f, ncp * c)[:, :w]
        out = torch.where(act[:, p, None], out & rows, out)
    return out


DENSE_TILE_WORDS = 160  # dense refine kernel: a tile, 32 lanes x 5 words
DENSE_GROUP = 8         # dense refine kernel: positions gathered at once


def refine_dense_schedule(n_words: int, row: int, n_active: int = 0,
                          base: int = 0) -> dict:
    """How the dense CUDA refine kernel splits row ``row`` of cand / out
    (int32 [F, n_words] whose first word lies ``base`` words past a
    16-byte boundary; the kernel reads it from the pointers), for a row
    with ``n_active`` active positions:

    * ``lead``: words from the 16-byte boundary before the row to the
      row's first word (the kernel's tiles start on that grid);
    * ``tiles``: the row word at each tile's first slot (tiles of
      ``DENSE_TILE_WORDS``, negative for a row that starts off the grid);
    * ``gather``: per tile, int64 [DENSE_TILE_WORDS], the row word that
      slot ``lane + 32 j`` gathers from every position's adjacency row
      (-1 off the row). Slot s holds word ``tile + s`` of the output too:
      the gathered rows are not realigned (shift 0);
    * ``head`` / ``tail``: the row words read and written one at a time,
      before the first and after the last 16-byte boundary;
    * ``body``: the first row word of each 16-byte unit read and written
      whole;
    * ``groups``: the positions (indices into the compacted list)
      gathered together, ``DENSE_GROUP`` at a time.
    """
    lead = (base + row * n_words) % 4
    tiles = list(range(-lead, n_words, DENSE_TILE_WORDS))
    slots = torch.arange(DENSE_TILE_WORDS)
    gather = [torch.where((t0 + slots >= 0) & (t0 + slots < n_words),
                          t0 + slots, -1) for t0 in tiles]
    head, body, tail = [], [], []
    for t0 in tiles:
        for w in range(t0, t0 + DENSE_TILE_WORDS, 4):
            words = [x for x in range(w, w + 4) if 0 <= x < n_words]
            if len(words) == 4:
                body.append(w)
            else:
                (head if w < 0 else tail).extend(words)
    groups = [list(range(g, min(g + DENSE_GROUP, n_active)))
              for g in range(0, n_active, DENSE_GROUP)]
    return {"lead": lead, "tiles": tiles, "gather": gather, "head": head,
            "body": body, "tail": tail, "groups": groups}


def refine_rows_by_schedule(adj_bitmap: torch.Tensor,
                            cand_rows: torch.Tensor, frontier: torch.Tensor,
                            active: torch.Tensor, base: int = 0
                            ) -> torch.Tensor:
    """:func:`refine_bitmap_rows_ref` computed the dense kernel's way, row
    by row on :func:`refine_dense_schedule`: the active, clamped vertices
    compacted in position order, each tile's slots ANDed over the groups
    of positions, then each unit of the tile (head, body or tail words)
    ANDed with cand into ``out``. A word the schedule misses stays 0."""
    v, w = adj_bitmap.shape
    out = torch.zeros_like(cand_rows)
    for i in range(cand_rows.shape[0]):
        act = (active[i] != 0) & (frontier[i] >= 0)
        verts = frontier[i][act].clamp(max=v - 1).long()
        sch = refine_dense_schedule(w, i, len(verts), base)
        for t0, slots in zip(sch["tiles"], sch["gather"]):
            acc = torch.full(slots.shape, -1, dtype=torch.int32)
            for group in sch["groups"]:
                for j in group:
                    acc &= torch.where(slots >= 0,
                                       adj_bitmap[verts[j]][slots.clamp(0)],
                                       -1)
            on = slots >= 0
            out[i, slots[on]] = cand_rows[i, slots[on]] & acc[on]
    return out


def refine_hier_schedule(chunk_ptr: torch.Tensor, vertices: torch.Tensor,
                         chunk_words: int) -> torch.Tensor:
    """The hier CUDA refine kernel's walk of one row, as int64 [units, 3]:
    flat unit i is (index into ``vertices``, stored chunk k (a row of
    ``chunk_data``), first word of the unit in that chunk).

    ``vertices`` are the row's active positions' vertices in position
    order, those below V (a vertex past V - 1 has no stored chunk). Each
    position's stored chunks ``chunk_ptr[v] .. chunk_ptr[v+1]`` follow
    one another, positions in order (the prefix sum of their chunk
    counts), and each chunk is cut into units of 4 words (C >= 4) or is
    one unit (C of 1 or 2). The kernel's threads take units i, i + 256,
    ... and read each unit's chunk id, then its chunk words if the chunk
    is live.
    """
    c = int(chunk_words)
    unit = min(c, 4)
    vertices = vertices.long()
    k0 = chunk_ptr[vertices].long()
    nk = chunk_ptr[vertices + 1].long() - k0
    pos = torch.repeat_interleave(torch.arange(len(vertices)), nk)
    first = torch.cumsum(nk, 0) - nk
    k = k0[pos] + torch.arange(len(pos)) - first[pos]
    per = c // unit
    return torch.stack([pos.repeat_interleave(per), k.repeat_interleave(per),
                        torch.arange(0, c, unit).repeat(len(pos))], dim=1)


def refine_rows_hier_by_schedule(summary: torch.Tensor,
                                 chunk_ptr: torch.Tensor,
                                 chunk_id: torch.Tensor,
                                 chunk_data: torch.Tensor,
                                 cand_rows: torch.Tensor,
                                 frontier: torch.Tensor,
                                 active: torch.Tensor) -> torch.Tensor:
    """:func:`refine_bitmap_rows_hier_ref` computed the hier kernel's way,
    row by row on :func:`refine_hier_schedule`: cand with the words of
    chunks dead in the active positions' summary intersection zeroed (a
    zero cand word needs no summary: it stays zero), then the chunk words
    of every unit of the flat walk whose chunk is live ANDed in, one
    walked position after another."""
    v, sw = summary.shape
    c = chunk_data.shape[1]
    w = cand_rows.shape[1]
    chunks = torch.arange(w) // c
    unit = torch.arange(min(c, 4))
    out = torch.zeros_like(cand_rows)
    for i in range(cand_rows.shape[0]):
        act = (active[i] != 0) & (frontier[i] >= 0)
        rows = summary[frontier[i][act].clamp(max=v - 1).long()]
        psum = _and_fold(rows[None])[0] if len(rows) else torch.full(
            (sw,), -1, dtype=torch.int32)
        live = (psum[chunks // 32] >> (chunks % 32)) & 1
        row = cand_rows[i] & -live.to(torch.int32)
        walk = refine_hier_schedule(chunk_ptr, frontier[i][act & (
            frontier[i] < v)], c)
        for p in range(int(walk[:, 0].max()) + 1 if len(walk) else 0):
            mine = walk[walk[:, 0] == p]
            ids = chunk_id[mine[:, 1]].long()
            words = (ids * c + mine[:, 2])[:, None] + unit
            data = chunk_data[mine[:, 1][:, None], mine[:, 2][:, None] + unit]
            keep = (((psum[ids // 32] >> (ids % 32)) & 1) != 0)[:, None] \
                & (words < w)
            full = torch.full((w,), -1, dtype=torch.int32)
            full[words[keep]] = data[keep]
            row &= full
        out[i] = row
    return out


SPMM_ROW_BLOCK = 4096   # rows unpacked at a time by bitmap_spmm_ref


def unpack_rows(words: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows ``lo:hi`` of the 0/1 matrix packed in ``words`` (int32
    [N, W], the bit patterns of the reference's uint32 words), as int32
    [hi - lo, 32 W]: bit b of word w is column 32 w + b."""
    blk = words[lo:hi]
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((blk[:, :, None] >> shifts) & 1).reshape(blk.shape[0], -1)


def bitmap_spmm_ref(adj_words: torch.Tensor, x: torch.Tensor
                    ) -> torch.Tensor:
    """``A @ x`` for the 0/1 matrix A [N, M] packed in ``adj_words``
    (int32 [N, W], the bit patterns of the reference's uint32 words; bit
    b of word w is column 32 w + b, M = 32 W). ``x`` [M, D] f32 or bf16;
    returns [N, D] in ``x.dtype``.

    Unpacks ``SPMM_ROW_BLOCK`` rows at a time to a dense block and multiplies
    it with ``torch.matmul`` in f64, rounding once to ``x.dtype``, so the
    dense matrix of a large graph (17 GB at 65536 vertices) is never
    built whole. The products are exact (A is 0/1), and the f64 sum is
    the exact sum to well below an f32 unit: the kernel's f32 sums,
    which carry their rounding error, are held to that. Two plain f32
    sums in different orders differ by more than the reference's 1e-5
    on rows of a few hundred set bits.
    """
    n = adj_words.shape[0]
    xf = x.double()
    out = torch.empty((n, x.shape[1]), dtype=x.dtype, device=x.device)
    for i in range(0, n, SPMM_ROW_BLOCK):
        hi = min(i + SPMM_ROW_BLOCK, n)
        out[i:hi] = (unpack_rows(adj_words, i, hi).double() @ xf).to(x.dtype)
    return out


def _two_sum(s: torch.Tensor, err: torch.Tensor, v: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Knuth's TwoSum in f32, as the kernel writes it: ``s + v`` and
    ``err`` plus that sum's rounding error."""
    t = s + v
    vp = t - s
    return t, err + ((s - (t - vp)) + (v - vp))


def spmm_split_schedule(adj_words: torch.Tensor, groups: int = 4,
                        pass_words: int = 512, window: int = 1024
                        ) -> torch.Tensor:
    """The CUDA kernel's order of x rows: int64 [N, groups, depth],
    entry ``[i, g, t]`` the column whose x row group g of row i's block
    adds at its step t, ``32 W`` (no row) past the end of its sequence.

    Each row's set columns, ascending, are cut into segments: the row is
    read ``pass_words`` words at a time, and each pass's bits go through
    a list of ``window`` entries. Each segment of n entries is cut into
    ``groups`` slices of ``ceil(n / groups)``; slice g of every segment,
    in order, is group g's sequence. With ``groups=1`` the sequence is
    the row's set columns in order, whatever the passes and windows.
    """
    n, w = adj_words.shape
    dev = adj_words.device
    rows = [torch.zeros(0, dtype=torch.int64, device=dev)]
    cols = [torch.zeros(0, dtype=torch.int64, device=dev)]
    for i in range(0, n, SPMM_ROW_BLOCK):
        r, c = unpack_rows(adj_words, i, min(i + SPMM_ROW_BLOCK, n)
                           ).nonzero(as_tuple=True)
        rows.append(r + i)
        cols.append(c)
    rows, cols = torch.cat(rows), torch.cat(cols)       # row-major, ascending
    nnz = rows.numel()
    # rank of each bit in its (row, pass), then its segment (row, pass,
    # window) and its place there
    n_pass = max(1, -(-w // pass_words))
    key = rows * n_pass + (cols // 32) // pass_words
    _, cnt = torch.unique_consecutive(key, return_counts=True)
    rank = torch.arange(nnz, device=dev) - torch.repeat_interleave(
        torch.cumsum(cnt, 0) - cnt, cnt)
    seg_key = key * (-(-32 * pass_words // window)) + rank // window
    _, seg_len = torch.unique_consecutive(seg_key, return_counts=True)
    seg = torch.repeat_interleave(torch.arange(seg_len.numel(), device=dev),
                                  seg_len)
    pos = rank % window
    span = -(-seg_len // groups)                        # slice length
    grp = pos // span[seg]
    # entries each group takes from each segment, counted from the row's
    # first segment: the offset of this segment's slice in the sequence
    g_ids = torch.arange(groups, device=dev)
    took = (seg_len[:, None] - g_ids * span[:, None]).clamp(0) \
        .minimum(span[:, None])                         # [segments, groups]
    before = torch.cumsum(took, 0) - took
    seg_row = rows[torch.cumsum(seg_len, 0) - seg_len]
    _, segs_per_row = torch.unique_consecutive(seg_row, return_counts=True)
    row_first = torch.repeat_interleave(
        torch.cumsum(segs_per_row, 0) - segs_per_row, segs_per_row)
    before = before - before[row_first]
    step = before[seg, grp] + pos - grp * span[seg]
    depth = int(step.max()) + 1 if nnz else 0
    idx = torch.full((n, groups, depth), 32 * w, dtype=torch.int64,
                     device=dev)
    idx[rows, grp, step] = cols
    return idx


def bitmap_spmm_split_ref(adj_words: torch.Tensor, x: torch.Tensor,
                          groups: int = 4, pass_words: int = 512,
                          window: int = 1024) -> torch.Tensor:
    """``A @ x`` as the CUDA kernel decomposes it, all in f32: the
    kernel's ``split`` route with its defaults (4 warps a row, passes of
    512 words, lists of 1024 entries); ``groups=1`` is the ``stream``
    and ``wide`` routes (one ascending sequence a row).

    Group g of each row adds the x rows of its sequence of
    :func:`spmm_split_schedule`, in order, into a TwoSum pair
    ``(s, err)`` (the kernel issues a few of the loads together; the
    adds stay in this order). Group 0's pair then takes in groups 1..
    in order (TwoSum on the sums, the errors added), and ``s + err`` is
    rounded once to ``x.dtype``.

    Every operation is the kernel's, in the kernel's order (an x row of
    zeros past a sequence's end adds nothing), so on the card the two
    agree bit for bit. ``bitmap_spmm_ref`` (f64) stays the plain version
    the kernel is held to.
    """
    n = adj_words.shape[0]
    d = x.shape[1]
    dev = x.device
    idx = spmm_split_schedule(adj_words, groups, pass_words, window)
    xz = torch.cat([x.float(), torch.zeros((1, d), device=dev)])  # row 32 W
    s = torch.zeros((n, groups, d), device=dev)
    err = torch.zeros_like(s)
    for k in range(idx.shape[2]):
        s, err = _two_sum(s, err, xz[idx[:, :, k]])
    total, total_err = s[:, 0], err[:, 0]
    for g in range(1, groups):
        total, total_err = _two_sum(total, total_err, s[:, g])
        total_err = total_err + err[:, g]
    return (total + total_err).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain softmax attention in f32, [B, H, S, D] queries against
    [B, Hkv, Skv, D] keys and values; query head h reads kv head
    ``h // (H // Hkv)`` (the kv heads are repeated here, in the plain
    version only). Returns q's dtype; ``scale = D ** -0.5``.

    The causal mask is the reference Pallas kernel's: key j is visible to
    query i iff ``j <= i``, both counted from 0 (top-left aligned). The
    reference's jnp oracle aligns it at the end (``tril(k=Skv - S)``);
    the two agree only when ``S == Skv``.
    """
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * q.shape[-1] ** -0.5
    if causal:
        s, t = logits.shape[-2:]
        mask = torch.ones((s, t), dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def flash_split_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, split_len: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``split`` route's first pass, in f32: for each (b, kv head,
    key split of ``split_len`` keys, the last one ragged) and each of the
    ``group * S`` query rows reading that kv head, the split's partial
    ``(m, l, acc)``: the largest visible scaled score, the sum of
    ``exp(score - m)`` over visible keys and their weighted sum of values.
    A row that sees no key of the split (causal, the split wholly past
    its position) gets the neutral partial ``(-1e30, 0, 0)``.

    Returns m, l [B, Hkv, n_splits, R] and acc [B, Hkv, n_splits, R, D].
    """
    b, h_kv, s_kv, d = k.shape
    s = q.shape[2]
    # the rows that read each kv head, in q's memory order: row r is
    # head r // S of the group, position r % S
    rows = q.float().reshape(b, h_kv, -1, d)
    pos = torch.arange(rows.shape[2], device=q.device) % s
    ms, ls, accs = [], [], []
    for k0 in range(0, s_kv, split_len):
        kt = k[:, :, k0:k0 + split_len].float()
        vt = v[:, :, k0:k0 + split_len].float()
        sc = torch.matmul(rows, kt.transpose(-1, -2)) * d ** -0.5
        keys = torch.arange(k0, k0 + kt.shape[2], device=q.device)
        seen = (keys[None, :] <= pos[:, None]) if causal else \
            torch.ones_like(sc[0, 0], dtype=torch.bool)
        m = sc.masked_fill(~seen, -1e30).amax(-1)
        p = torch.where(seen, torch.exp(sc - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.matmul(p, vt))
    return torch.stack(ms, 2), torch.stack(ls, 2), torch.stack(accs, 2)


def flash_split_combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                        q_shape, dtype: torch.dtype) -> torch.Tensor:
    """The ``split`` route's combine pass: each split's partial rescaled
    to the rows' largest max and summed, divided by the summed weights,
    rounded once to ``dtype``; returns [B, H, S, D] as ``q_shape``."""
    w = torch.exp(m - m.amax(2, keepdim=True))
    total = (w * l).sum(2).clamp_min(1e-30)
    out = (w[..., None] * acc).sum(2) / total[..., None]
    return out.reshape(q_shape).to(dtype)


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              split_len: int = 256) -> torch.Tensor:
    """Attention as the ``split`` route decomposes it (split-K over the
    keys, the GQA group folded into each kv head's rows, then a combine):
    :func:`flash_split_partials` then :func:`flash_split_combine`."""
    m, l, acc = flash_split_partials(q, k, v, causal, split_len)
    return flash_split_combine(m, l, acc, q.shape, q.dtype)


def flash_attention_tc_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool = True, tile: int = 64
                           ) -> torch.Tensor:
    """Attention with the ``tc`` route's numerics: keys in tiles of
    ``tile``, scores from the inputs summed in f32, an online softmax in
    f32 (the row sum taken over the f32 weights), the weights rounded to
    bf16 before they multiply V (the tensor cores' A operand), the sum in
    f32 and the output rounded once to q's dtype. Key tiles wholly past
    the causal diagonal are skipped, as the kernel skips them."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    qf = q.float()
    s_kv = k.shape[2]
    m = torch.full((b, h, s), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    pos = torch.arange(s, device=q.device)
    n_keys = min(s_kv, s) if causal else s_kv
    for k0 in range(0, n_keys, tile):
        sc = torch.matmul(qf, kf[:, :, k0:k0 + tile].transpose(-1, -2)) \
            * d ** -0.5
        if causal:
            keys = torch.arange(k0, k0 + sc.shape[-1], device=q.device)
            sc = sc.masked_fill(keys[None, :] > pos[:, None], float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(
            p.to(torch.bfloat16).float(), vf[:, :, k0:k0 + tile])
        m = m_new
    return (acc / l[..., None]).to(q.dtype)
