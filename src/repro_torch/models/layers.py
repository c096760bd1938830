"""Shared neural-network layers (twin of ``repro.models.layers``).

A layer is an ``nn.Module`` whose parameters carry the reference's
pytree names (``Dense.w`` is ``[d_in, d_out]``, as ``dense_init`` makes
it, not ``nn.Linear``'s ``[out, in]``), plus the reference's functions
by name. Attention math runs in float32 whatever the compute dtype, as
in the reference.

Decode writes its KV cache in place: ``attn_apply`` with a cache stores
this step's keys and values into the given cache tensors (a slice write
where the reference returns an updated copy) and returns the same
tensors with the new length.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.config import resolve_device

DRAW_CHUNK = 1 << 26        # elements drawn at once (bounds the f32 temp)
MESH_ITEM = ("the mesh and sharding paths are not ported yet (ROADMAP "
             "queue 1 item 9: launch/ and the mesh paths)")


def no_mesh(cfg, *fields) -> None:
    """Raise for any mesh or sharding field of ``cfg`` that is set: the
    port has only the local path and never takes it silently."""
    for f in fields:
        if getattr(cfg, f) not in (None, False):
            raise NotImplementedError(
                f"{type(cfg).__name__}.{f}={getattr(cfg, f)!r}: {MESH_ITEM}")


# --------------------------------------------------------------- init
def normal(gen: torch.Generator, shape, std: float, dtype, device
           ) -> torch.Tensor:
    """N(0, std^2) of ``shape`` in ``dtype`` on ``device``, drawn in
    float32 on the generator's own device in slices of at most
    ``DRAW_CHUNK`` elements along axis 0. On ``"meta"`` nothing is
    drawn."""
    device = torch.device(device)
    out = torch.empty(shape, dtype=dtype, device=device)
    if device.type == "meta":
        return out
    if out.dim() == 0 or out.numel() <= DRAW_CHUNK:
        return torch.randn(shape, generator=gen, device=gen.device
                           ).mul_(std).to(device=device, dtype=dtype)
    rows = max(1, DRAW_CHUNK // (out.numel() // out.shape[0]))
    for i in range(0, out.shape[0], rows):
        part = out[i:i + rows]
        part.copy_(torch.randn(part.shape, generator=gen,
                               device=gen.device).mul_(std))
    return out


def ones(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(shape, dtype=dtype, device=device))


def zeros(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


def remat(fn, *args):
    """``jax.checkpoint``: recompute ``fn`` in the backward pass, only
    while grad is enabled (inference keeps no graph to save)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# --------------------------------------------------------------- rope
def _inv_freq(d: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=device) / d))


def rope_freqs(head_dim: int, max_pos: int, theta: float = 1e4,
               device="cuda") -> torch.Tensor:
    device = resolve_device(device)
    pos = torch.arange(max_pos, dtype=torch.float32, device=device)
    return torch.outer(pos, _inv_freq(head_dim, theta, device))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding. x: [B, S, H, D] or [B, S, D]; positions: [S]
    absolute positions shared across the batch. Rotates interleaved
    (even, odd) pairs, as the reference does (not the half-split
    layout)."""
    d = x.shape[-1]
    ang = positions.float()[:, None] * _inv_freq(d, theta, x.device)
    if x.dim() == 4:
        ang = ang[None, :, None, :]
    elif x.dim() == 3:
        ang = ang[None]
    else:
        raise ValueError(f"unsupported rope input rank {x.dim()}")
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------- linear
class Dense(nn.Module):
    """``dense_init``: ``w`` [*stack, d_in, d_out] ~ N(0, scale^2) (scale
    d_in^-1/2 by default), optional zero bias ``b`` [*stack, d_out].
    ``stack`` gives a leading axis of independent layers (the MoE's
    experts), as the reference's ``vmap`` of the init does."""

    def __init__(self, gen, d_in: int, d_out: int, dtype, bias=False,
                 scale=None, *, device="cuda", stack=()):
        super().__init__()
        device = resolve_device(device)
        std = scale if scale is not None else d_in ** -0.5
        self.w = nn.Parameter(normal(gen, (*stack, d_in, d_out), std, dtype,
                                     device))
        self.b = zeros((*stack, d_out), dtype, device) if bias else None


dense_init = Dense


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y


# --------------------------------------------------------------- attention
@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    attn_chunk: int = 1024      # kv-chunk size of the online-softmax loop


class Attention(nn.Module):
    """``attn_init``: ``wq``, ``wk``, ``wv``, ``wo`` and, with qk-norm,
    ``q_norm`` / ``k_norm``."""

    def __init__(self, gen, cfg: AttnConfig, dtype, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = Dense(gen, cfg.d_model, h * d, dtype, cfg.qkv_bias,
                        device=device)
        self.wk = Dense(gen, cfg.d_model, hk * d, dtype, cfg.qkv_bias,
                        device=device)
        self.wv = Dense(gen, cfg.d_model, hk * d, dtype, cfg.qkv_bias,
                        device=device)
        self.wo = Dense(gen, h * d, cfg.d_model, dtype,
                        scale=(h * d) ** -0.5, device=device)
        if cfg.qk_norm:
            self.q_norm = ones((d,), dtype, device)
            self.k_norm = ones((d,), dtype, device)


attn_init = Attention


def chunked_sdpa(q, k, v, *, causal: bool = True, q_offset: int = 0,
                 chunk: int = 1024, valid_len=None) -> torch.Tensor:
    """Memory-efficient attention: a loop over key/value chunks with an
    online softmax. q: [B, S, H, D]; k/v: [B, T, Hkv, D]. Never
    materialises [S, T]; each chunk's body is recomputed in the backward
    pass (``remat``).

    ``q_offset``: absolute position of q[0] (causal masking for chunked
    prefill); ``valid_len``: mask key positions >= valid_len (KV caches).
    """
    b, s, h, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = d ** -0.5
    n_chunks = -(-t // chunk)
    t_pad = n_chunks * chunk
    if t_pad != t:
        k = F.pad(k, (0, 0, 0, 0, 0, t_pad - t))
        v = F.pad(v, (0, 0, 0, 0, 0, t_pad - t))
    t_valid = valid_len if valid_len is not None else t
    qf = q.reshape(b, s, hk, g, d).float()
    qpos = torch.arange(s, device=q.device) + q_offset

    def body(m, l, acc, kblk, vblk, base):
        logits = torch.einsum("bshgd,bchd->bshgc", qf, kblk.float()) * scale
        kpos = base + torch.arange(chunk, device=q.device)
        mask = (kpos[None, :] < t_valid).expand(s, chunk)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        logits = torch.where(mask[None, :, None, None, :], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bshgc,bchd->bshgd", p,
                                                   vblk.float())
        return m_new, l, acc

    m = torch.full((b, s, hk, g), -1e30, device=q.device)
    l = torch.zeros((b, s, hk, g), device=q.device)
    acc = torch.zeros((b, s, hk, g, d), device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        m, l, acc = remat(body, m, l, acc, k[:, sl], v[:, sl], c * chunk)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, s, h, d).to(q.dtype)


def _attend(qf, k, v, mask):
    """Softmax attention of f32 queries [B, S, Hkv, G, D] over k/v
    [B, T, Hkv, D] under ``mask`` [S, T] (or None) -> [B, S, Hkv, G, D]."""
    d = qf.shape[-1]
    logits = torch.einsum("bshgd,bthd->bhgst", qf, k.float()) * (d ** -0.5)
    if mask is not None:
        logits = torch.where(mask[None, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgst,bthd->bshgd", probs, v.float())


def _sdpa(q, k, v, causal: bool, q_offset=None) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,T,Hkv,D] -> [B,S,H,D]; f32 softmax math.

    ``q_offset``: absolute position of the first query (causal masking
    of decode / chunked prefill where S != T); by default the mask is
    aligned at ``T - S``.
    """
    b, s, h, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    qf = q.reshape(b, s, hk, h // hk, d).float()
    mask = None
    if causal:
        off = q_offset if q_offset is not None else t - s
        qpos = torch.arange(s, device=q.device)[:, None] + off
        mask = torch.arange(t, device=q.device)[None, :] <= qpos
    return _attend(qf, k, v, mask).reshape(b, s, h, d).to(q.dtype)


def _masked_sdpa(q, k, v, mask) -> torch.Tensor:
    b, s, h, d = q.shape
    hk = k.shape[2]
    qf = q.reshape(b, s, hk, h // hk, d).float()
    return _attend(qf, k, v, mask).reshape(b, s, h, d).to(q.dtype)


def attn_qkv(p: Attention, cfg: AttnConfig, x, positions):
    """The projected, normed and rotated q [B,S,H,D], k, v [B,S,Hkv,D]
    that ``attn_apply`` attends with."""
    b, s, _ = x.shape
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(p.wq, x).reshape(b, s, h, d)
    k = dense(p.wk, x).reshape(b, s, hk, d)
    v = dense(p.wv, x).reshape(b, s, hk, d)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attn_apply(p: Attention, cfg: AttnConfig, x: torch.Tensor,
               positions: torch.Tensor, kv_cache=None, causal: bool = True):
    """Returns (y, new_kv_cache). kv_cache = (k, v, length) with k/v
    [B, S_max, Hkv, D] and ``length`` an int, or None for the plain
    forward. The cache tensors are written in place and returned with
    ``length + S``."""
    b, s, _ = x.shape
    q, k, v = attn_qkv(p, cfg, x, positions)
    if kv_cache is None:
        if s > cfg.attn_chunk:
            y = chunked_sdpa(q, k, v, causal=causal,
                             chunk=min(cfg.attn_chunk, s))
        else:
            y = _sdpa(q, k, v, causal=causal)
        new_cache = None
    else:
        ck, cv, length = kv_cache
        ck[:, length:length + s] = k.to(ck.dtype)
        cv[:, length:length + s] = v.to(cv.dtype)
        kpos = torch.arange(ck.shape[1], device=x.device)
        mask = (kpos[None, :] < length + s) \
            & (kpos[None, :] <= positions[:s, None])
        y = _masked_sdpa(q, ck, cv, mask)
        new_cache = (ck, cv, length + s)
    y = y.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return dense(p.wo, y), new_cache


# --------------------------------------------------------------- mlp
class SwiGLU(nn.Module):
    """``swiglu_init``: ``wg``, ``wu`` [d_model, d_ff], ``wd`` [d_ff,
    d_model]; ``stack`` as in ``Dense``."""

    def __init__(self, gen, d_model: int, d_ff: int, dtype, *,
                 device="cuda", stack=()):
        super().__init__()
        self.wg = Dense(gen, d_model, d_ff, dtype, device=device,
                        stack=stack)
        self.wu = Dense(gen, d_model, d_ff, dtype, device=device,
                        stack=stack)
        self.wd = Dense(gen, d_ff, d_model, dtype, scale=d_ff ** -0.5,
                        device=device, stack=stack)


swiglu_init = SwiGLU


def swiglu_apply(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return dense(p.wd, F.silu(dense(p.wg, x)) * dense(p.wu, x))


class GeluMLP(nn.Module):
    """``gelu_mlp_init``: ``wi`` [d_model, d_ff], ``wo`` [d_ff, d_model],
    with biases by default."""

    def __init__(self, gen, d_model: int, d_ff: int, dtype,
                 bias: bool = True, *, device="cuda"):
        super().__init__()
        self.wi = Dense(gen, d_model, d_ff, dtype, bias, device=device)
        self.wo = Dense(gen, d_ff, d_model, dtype, bias,
                        scale=d_ff ** -0.5, device=device)


gelu_mlp_init = GeluMLP


def gelu_mlp_apply(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return dense(p.wo, F.gelu(dense(p.wi, x), approximate="tanh"))
