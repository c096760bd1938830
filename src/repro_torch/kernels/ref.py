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
        cols = act.any(dim=0).nonzero()
        positions = int(cols.max()) + 1 if cols.numel() else 0
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
