"""Multi-head Latent Attention, DeepSeek-V2/V3 (twin of
``repro.models.mla``, its local path).

K/V are compressed into a latent ``c_kv`` plus a shared RoPE key
channel; the KV cache stores only ``[B, S, d_c + d_rope]``. The prefill
walks latent chunks with an online softmax and expands per-head K/V
inside each (recomputed) chunk; decode uses the absorbed form (``W_uk``
folded into the query, ``W_uv`` into the output) on the latent cache,
which it writes in place. The flash-decoding path under a mesh
(``mla_decode_flash``) is not ported: ``mesh``, ``dp_axis``, ``tp_axis``
or ``decode_flash`` set raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.config import resolve_device
from .layers import Dense, apply_rope, dense, no_mesh, ones, remat, rms_norm


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
    dp_axis: Any = None       # mesh fields: must stay unset here
    tp_axis: Any = None
    mesh: Any = None
    decode_flash: bool = False

    def __post_init__(self):
        no_mesh(self, "dp_axis", "tp_axis", "mesh", "decode_flash")


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
    q = dense(p.w_uq, cq).reshape(b, s, cfg.n_heads, cfg.d_nope + cfg.d_rope)
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
        k_nope = dense(p.w_uk, c_blk).reshape(b, ck, h, cfg.d_nope)
        v_blk = dense(p.w_uv, c_blk).reshape(b, ck, h, cfg.d_v)
        logits = (torch.einsum("bshd,bchd->bshc", qf_n, k_nope.float())
                  + torch.einsum("bshd,bcd->bshc", qf_r, r_blk.float())
                  ) * scale
        kpos = base + torch.arange(ck, device=x.device)
        mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < s)
        logits = torch.where(mask[None, :, None, :], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        pr = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + pr.sum(-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bshc,bchd->bshd", pr, v_blk.float())
        return m_new, l_new, acc_new

    m = torch.full((b, s, h), -1e30, device=x.device)
    l = torch.zeros((b, s, h), device=x.device)
    acc = torch.zeros((b, s, h, cfg.d_v), device=x.device)
    for c in range(n_chunks):
        sl = slice(c * ck, (c + 1) * ck)
        m, l, acc = remat(body, m, l, acc, c_kv[:, sl], k_rope[:, sl],
                          c * ck)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(b, s, h * cfg.d_v).to(x.dtype)
    return dense(p.w_o, out)


def mla_init_cache(cfg: MLAConfig, batch: int, s_max: int, dtype,
                   device="cuda") -> tuple:
    device = resolve_device(device)
    return (torch.zeros((batch, s_max, cfg.d_c), dtype=dtype, device=device),
            torch.zeros((batch, s_max, cfg.d_rope), dtype=dtype,
                        device=device),
            0)


def mla_decode_apply(p: MLA, cfg: MLAConfig, x: torch.Tensor,
                     cache) -> tuple[torch.Tensor, tuple]:
    """Absorbed-form decode step. x: [B, S, d] (S typically 1); cache
    ``(c [B, S_max, d_c], r [B, S_max, d_rope], length)``, written in
    place at ``length`` and returned with ``length + S``."""
    b, s, _ = x.shape
    h = cfg.n_heads
    c_cache, r_cache, length = cache
    positions = length + torch.arange(s, device=x.device)
    q_nope, q_rope = _q_proj(p, cfg, x, positions)
    c_kv, k_rope = _latent(p, cfg, x, positions)
    c_cache[:, length:length + s] = c_kv.to(c_cache.dtype)
    r_cache[:, length:length + s] = k_rope.to(r_cache.dtype)
    t = c_cache.shape[1]
    w_uk = p.w_uk.w.reshape(cfg.d_c, h, cfg.d_nope)
    q_abs = torch.einsum("bshd,chd->bshc", q_nope.float(), w_uk.float())
    scale = (cfg.d_nope + cfg.d_rope) ** -0.5
    logits = (torch.einsum("bshc,btc->bhst", q_abs, c_cache.float())
              + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             r_cache.float())) * scale
    kpos = torch.arange(t, device=x.device)
    mask = kpos[None, :] <= positions[:, None]
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    lat = torch.einsum("bhst,btc->bshc", probs, c_cache.float())
    w_uv = p.w_uv.w.reshape(cfg.d_c, h, cfg.d_v)
    out = torch.einsum("bshc,chd->bshd", lat, w_uv.float())
    out = out.reshape(b, s, h * cfg.d_v).to(x.dtype)
    return dense(p.w_o, out), (c_cache, r_cache, length + s)
