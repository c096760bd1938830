"""Multi-head Latent Attention, DeepSeek-V2/V3 (twin of
``repro.models.mla``).

K/V are compressed into a latent ``c_kv`` plus a shared RoPE key
channel; the KV cache stores only ``[B, S, d_c + d_rope]``. The prefill
walks latent chunks with an online softmax and expands per-head K/V
inside each (recomputed) chunk; decode uses the absorbed form (``W_uk``
folded into the query, ``W_uv`` into the output) on the latent cache,
which it writes in place. Under a mesh the prefill's queries and
softmax state stay sequence-sharded (``_cst``), and a decode cell with
``decode_flash`` runs ``mla_decode_flash``: the latent cache sharded
over the sequence, each shard writing only the slice it owns and the
shards merging their partial softmax state.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.config import resolve_device
from ..launch.sharding import P
from .layers import (Dense, apply_rope, axis_index, axis_size, constrain,
                     dense, einsum, ones, pmax, psum, query_rows, remat,
                     reshape, rms_norm, shard_map, softmax,
                     write_rows)


def _cst(x, cfg: "MLAConfig", *axes):
    if cfg.dp_axis is None:
        return x
    return constrain(x, P(*axes))


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    d_c: int = 512            # kv compression dim
    d_cq: int = 1536          # q compression dim
    d_nope: int = 128         # per-head non-rope dim
    d_rope: int = 64          # per-head rope dim (shared k channel)
    d_v: int = 128            # per-head value dim
    rope_theta: float = 1e4
    dp_axis: Any = None       # activation sharding (set by launch/steps)
    tp_axis: Any = None
    mesh: Any = None          # DeviceMesh + decode_flash => flash-decoding
    decode_flash: bool = False


class MLA(nn.Module):
    """``mla_init``: the down / up projections and the two latent norms."""

    def __init__(self, gen, cfg: MLAConfig, dtype, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        h = cfg.n_heads

        def lin(d_in, d_out, **kw):
            return Dense(gen, d_in, d_out, dtype, device=device, **kw)
        self.w_dq = lin(cfg.d_model, cfg.d_cq)
        self.q_norm = ones((cfg.d_cq,), dtype, device)
        self.w_uq = lin(cfg.d_cq, h * (cfg.d_nope + cfg.d_rope))
        self.w_dkv = lin(cfg.d_model, cfg.d_c)
        self.kv_norm = ones((cfg.d_c,), dtype, device)
        self.w_kr = lin(cfg.d_model, cfg.d_rope)
        self.w_uk = lin(cfg.d_c, h * cfg.d_nope)
        self.w_uv = lin(cfg.d_c, h * cfg.d_v)
        self.w_o = lin(h * cfg.d_v, cfg.d_model, scale=(h * cfg.d_v) ** -0.5)


mla_init = MLA


def _q_proj(p: MLA, cfg: MLAConfig, x, positions):
    b, s, _ = x.shape
    cq = rms_norm(dense(p.w_dq, x), p.q_norm)
    q = reshape(dense(p.w_uq, cq), b, s, cfg.n_heads,
                cfg.d_nope + cfg.d_rope)
    q_nope, q_rope = q[..., :cfg.d_nope], q[..., cfg.d_nope:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latent(p: MLA, cfg: MLAConfig, x, positions):
    """(c_kv [B, S, d_c], k_rope [B, S, d_rope]) of x."""
    return (rms_norm(dense(p.w_dkv, x), p.kv_norm),
            apply_rope(dense(p.w_kr, x), positions, cfg.rope_theta))


def mla_train_apply(p: MLA, cfg: MLAConfig, x: torch.Tensor,
                    positions: torch.Tensor, chunk: int = 1024
                    ) -> torch.Tensor:
    """Training / prefill forward (no cache), causal. x: [B, S, d].

    The online softmax walks latent chunks and expands per-head K/V per
    chunk inside the recomputed body, so neither [S, S] scores nor the
    full per-head K/V materialise.
    """
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _q_proj(p, cfg, x, positions)
    # queries (and the softmax state) stay sequence-sharded; only the
    # small latent K-side is gathered chunk by chunk
    q_nope = _cst(q_nope, cfg, cfg.dp_axis, cfg.tp_axis, None, None)
    q_rope = _cst(q_rope, cfg, cfg.dp_axis, cfg.tp_axis, None, None)
    c_kv, k_rope = _latent(p, cfg, x, positions)
    scale = (cfg.d_nope + cfg.d_rope) ** -0.5
    ck = min(chunk, s)
    n_chunks = -(-s // ck)
    if n_chunks * ck != s:
        c_kv = F.pad(c_kv, (0, 0, 0, n_chunks * ck - s))
        k_rope = F.pad(k_rope, (0, 0, 0, n_chunks * ck - s))
    qf_n, qf_r = q_nope.float(), q_rope.float()
    qpos = positions.long()

    def body(m, l, acc, c_blk, r_blk, base):
        k_nope = reshape(dense(p.w_uk, c_blk), b, ck, h, cfg.d_nope)
        v_blk = reshape(dense(p.w_uv, c_blk), b, ck, h, cfg.d_v)
        # under a mesh: each rank expands the whole chunk for its own
        # query rows (layout only)
        _, k_nope, v_blk, r_blk = query_rows(x, q_nope, k_nope, v_blk, r_blk)
        logits = (einsum("bshd,bchd->bshc", qf_n, k_nope.float())
                  + einsum("bshd,bcd->bshc", qf_r, r_blk.float())
                  ) * scale
        kpos = base + torch.arange(ck, device=x.device)
        mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < s)
        logits = torch.where(mask[None, :, None, :], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        pr = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + pr.sum(-1)
        acc_new = acc * corr[..., None] + einsum(
            "bshc,bchd->bshd", pr, v_blk.float())
        return (_cst(m_new, cfg, cfg.dp_axis, cfg.tp_axis, None),
                _cst(l_new, cfg, cfg.dp_axis, cfg.tp_axis, None),
                _cst(acc_new, cfg, cfg.dp_axis, cfg.tp_axis, None, None))

    # the softmax state laid out as the queries are (under a mesh, a
    # plain tensor would be each rank's whole copy)
    m = torch.full_like(qf_n[..., 0], -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(m)[..., None].expand(b, s, h, cfg.d_v)
    for c in range(n_chunks):
        sl = slice(c * ck, (c + 1) * ck)
        m, l, acc = remat(body, m, l, acc, c_kv[:, sl], k_rope[:, sl],
                          c * ck)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = reshape(out, b, s, h * cfg.d_v).to(x.dtype)
    out = _cst(out, cfg, cfg.dp_axis, cfg.tp_axis, None)
    return dense(p.w_o, out)


def mla_init_cache(cfg: MLAConfig, batch: int, s_max: int, dtype,
                   device="cuda") -> tuple:
    device = resolve_device(device)
    return (torch.zeros((batch, s_max, cfg.d_c), dtype=dtype, device=device),
            torch.zeros((batch, s_max, cfg.d_rope), dtype=dtype,
                        device=device),
            0)


def mla_decode_flash(p: MLA, cfg: MLAConfig, x, cache) -> tuple:
    """Flash-decoding MLA step under ``shard_map``.

    The latent cache is sequence-sharded over the model axis; each shard
    writes this step's latent into the cache slice it owns, in place,
    where ``length`` falls in its range (the reference's masked
    dynamic-update-slice, whose start is clamped into the shard), computes
    its partial online-softmax state against its local keys, and the
    shards merge by ``pmax`` / ``psum``: per layer only the [B_l, H,
    d_c] partial accumulator crosses shards, never the cache.
    """
    mesh, dpa, tp = cfg.mesh, cfg.dp_axis, cfg.tp_axis
    b, s, _ = x.shape
    h = cfg.n_heads
    c_cache, r_cache, length = cache
    s_max = c_cache.shape[1]
    s_shard = s_max // axis_size(mesh, tp)
    scale = (cfg.d_nope + cfg.d_rope) ** -0.5
    # the weights the body reads, whole on every shard (the reference's
    # closure over them)
    names = ("w_dq", "w_uq", "w_dkv", "w_kr", "w_uk")
    weights = [getattr(p, n).w for n in names] + [p.q_norm, p.kv_norm]

    def inner(xl, c_l, r_l, *ws):
        lp = SimpleNamespace(**{n: SimpleNamespace(w=w, b=None)
                                for n, w in zip(names, ws)},
                             q_norm=ws[-2], kv_norm=ws[-1])
        positions = length + torch.arange(s, device=xl.device)
        q_nope, q_rope = _q_proj(lp, cfg, xl, positions)   # [B_l,S,H,*]
        c_new, r_new = _latent(lp, cfg, xl, positions)
        lo = axis_index(mesh, tp) * s_shard
        if lo <= length < lo + s_shard:
            at = min(max(length - lo, 0), s_shard - 1, s_shard - s)
            c_l[:, at:at + s] = c_new.to(c_l.dtype)
            r_l[:, at:at + s] = r_new.to(r_l.dtype)
        w_uk = lp.w_uk.w.reshape(cfg.d_c, h, cfg.d_nope)
        q_abs = einsum("bshd,chd->bshc", q_nope.float(),
                             w_uk.float())                  # [B_l,S,H,d_c]
        logits = (einsum("bshc,btc->bhst", q_abs, c_l.float())
                  + einsum("bshd,btd->bhst", q_rope.float(),
                                 r_l.float())) * scale
        kpos = lo + torch.arange(s_shard, device=xl.device)
        mask = kpos[None, :] <= positions[:, None]
        logits = torch.where(mask[None, None], logits, -1e30)
        m = pmax(logits.amax(-1), mesh, tp)                 # [B_l,H,S]
        pr = torch.exp(logits - m[..., None])
        l_sum = psum(pr.sum(-1), mesh, tp)
        acc = psum(einsum("bhst,btc->bshc", pr, c_l.float()),
                   mesh, tp)                                # [B_l,S,H,d_c]
        return acc / torch.clamp(l_sum, min=1e-30).transpose(1, 2)[..., None]

    lat = shard_map(inner, mesh,
                    (P(dpa, None, None), P(dpa, tp, None), P(dpa, tp, None))
                    + tuple(P(*([None] * w.dim())) for w in weights),
                    P(dpa, None, None, None))(x, c_cache, r_cache, *weights)
    w_uv = reshape(p.w_uv.w, cfg.d_c, h, cfg.d_v)
    out = einsum("bshc,chd->bshd", lat, w_uv.float())
    out = reshape(out, b, s, h * cfg.d_v).to(x.dtype)
    return dense(p.w_o, out), (c_cache, r_cache, length + s)


def mla_decode_apply(p: MLA, cfg: MLAConfig, x: torch.Tensor,
                     cache) -> tuple[torch.Tensor, tuple]:
    """Absorbed-form decode step. x: [B, S, d] (S typically 1); cache
    ``(c [B, S_max, d_c], r [B, S_max, d_rope], length)``, written in
    place at ``length`` and returned with ``length + S``."""
    if cfg.decode_flash and cfg.mesh is not None:
        return mla_decode_flash(p, cfg, x, cache)
    b, s, _ = x.shape
    h = cfg.n_heads
    c_cache, r_cache, length = cache
    positions = length + torch.arange(s, device=x.device)
    q_nope, q_rope = _q_proj(p, cfg, x, positions)
    c_kv, k_rope = _latent(p, cfg, x, positions)
    write_rows(c_cache, 1, length, c_kv.to(c_cache.dtype))
    write_rows(r_cache, 1, length, k_rope.to(r_cache.dtype))
    t = c_cache.shape[1]
    w_uk = reshape(p.w_uk.w, cfg.d_c, h, cfg.d_nope)
    q_abs = einsum("bshd,chd->bshc", q_nope.float(), w_uk.float())
    scale = (cfg.d_nope + cfg.d_rope) ** -0.5
    logits = (einsum("bshc,btc->bhst", q_abs, c_cache.float())
              + einsum("bshd,btd->bhst", q_rope.float(),
                             r_cache.float())) * scale
    kpos = torch.arange(t, device=x.device)
    mask = kpos[None, :] <= positions[:, None]
    logits = torch.where(mask[None, None], logits, -1e30)
    lat = einsum("bhst,btc->bshc", softmax(logits), c_cache.float())
    w_uv = reshape(p.w_uv.w, cfg.d_c, h, cfg.d_v)
    out = einsum("bshc,chd->bshd", lat, w_uv.float())
    out = reshape(out, b, s, h * cfg.d_v).to(x.dtype)
    return dense(p.w_o, out), (c_cache, r_cache, length + s)
