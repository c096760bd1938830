"""Mixture-of-Experts FFN, DeepSeek-V3 / Kimi-K2 style (twin of
``repro.models.moe``, its local path).

Shared expert(s) plus fine-grained routed experts with sigmoid top-k
routing and the aux-loss-free bias. Dispatch is group-local as in the
reference: tokens split into ``dispatch_groups`` groups, each sorted by
expert (a stable sort, as ``jnp.argsort``), clipped to a per-(group,
expert) capacity ``C = T_local*k/E * capacity_factor`` and scattered
into expert slots; overflow tokens are dropped (into a trash row that is
sliced off, as the reference's ``mode="drop"`` scatter drops slot
``E*C``). The routed experts stay stacked ``[E, ...]`` and run as one
batched product. The mesh paths (``_moe_shard_map``,
``_local_sort_dispatch``) are not ported: any mesh or sharding field
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..kernels.config import resolve_device
from .layers import Dense, SwiGLU, no_mesh, swiglu_apply, zeros


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int            # routed experts
    top_k: int
    d_ff_expert: int          # per-expert hidden dim
    n_shared: int = 1         # shared experts (always-on)
    d_ff_shared: int | None = None   # defaults to d_ff_expert * n_shared
    capacity_factor: float = 1.25
    router_dtype: Any = torch.float32
    bias_update_rate: float = 1e-3   # aux-free load-balance bias (DSv3)
    ep_axis: Any = None              # mesh fields: must stay None here
    token_axes: Any = None
    cap_axes: Any = None
    dispatch_groups: int = 1         # G token groups, each routed alone
    mesh: Any = None
    dp_axes: Any = None
    seq_axis: Any = None

    def __post_init__(self):
        no_mesh(self, "ep_axis", "token_axes", "cap_axes", "mesh",
                "dp_axes", "seq_axis")


class MoE(nn.Module):
    """``moe_init``: ``router`` (f32 [d, E]), ``router_bias`` (f32 [E]),
    ``experts`` (a SwiGLU stacked over E) and, with shared experts,
    ``shared``."""

    def __init__(self, gen, d_model: int, cfg: MoEConfig, dtype, *,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.router = Dense(gen, d_model, cfg.n_experts, torch.float32,
                            device=device)
        self.router_bias = zeros((cfg.n_experts,), torch.float32, device)
        self.experts = SwiGLU(gen, d_model, cfg.d_ff_expert, dtype,
                              device=device, stack=(cfg.n_experts,))
        if cfg.n_shared > 0:
            d_sh = cfg.d_ff_shared or cfg.d_ff_expert * cfg.n_shared
            self.shared = SwiGLU(gen, d_model, d_sh, dtype, device=device)
        else:
            self.shared = None


moe_init = MoE


def _route(p: MoE, cfg: MoEConfig, flat: torch.Tensor):
    """flat: [T, d] -> (top_idx [T, K], top_w [T, K]); sigmoid + aux-free
    bias selection, weights from the unbiased scores (DSv3 §2.1.2)."""
    scores = torch.sigmoid(flat.to(cfg.router_dtype) @ p.router.w)
    biased = scores + p.router_bias[None, :]
    top_idx = torch.topk(biased, cfg.top_k, dim=1, sorted=True).indices
    top_w = torch.gather(scores, 1, top_idx)
    top_w = top_w / (top_w.sum(1, keepdim=True) + 1e-9)
    return top_idx, top_w


def capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    e, k = cfg.n_experts, cfg.top_k
    return int(max(k, round(tokens_per_group * k / e
                            * cfg.capacity_factor)))


def _dispatch_slots(top_idx: torch.Tensor, cap: int, n_experts: int):
    """The sort-based dispatch of one group: (pt, slot, order). ``order``
    is the stable sort of the (token, choice) pairs by expert, ``pt`` the
    token of each sorted pair and ``slot`` its row in the [E*C] buffer
    (``E*C`` when dropped at capacity)."""
    tl, k = top_idx.shape
    pair_e = top_idx.reshape(-1)
    order = torch.argsort(pair_e, stable=True)
    pe = pair_e[order]
    pt = torch.arange(tl, device=top_idx.device).repeat_interleave(k)[order]
    counts = torch.bincount(pe, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    idx_in_e = torch.arange(tl * k, device=top_idx.device) - starts[pe]
    slot = torch.where(idx_in_e < cap, pe * cap + idx_in_e,
                       n_experts * cap)
    return pt, slot, order


def moe_apply(p: MoE, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]."""
    b, s, d = x.shape
    t = b * s
    g = max(1, cfg.dispatch_groups)
    if t % g != 0:   # ragged fallback (smoke shapes): single group
        g = 1
    tl = t // g
    e = cfg.n_experts
    cap = capacity(cfg, tl)
    xs = x.reshape(g, tl, d)
    bufs, combs = [], []
    for xg in xs:
        top_idx, top_w = _route(p, cfg, xg)
        pt, slot, order = _dispatch_slots(top_idx, cap, e)
        pw = top_w.reshape(-1)[order]
        # one trash row takes the dropped pairs, then is sliced off
        buf = x.new_zeros(e * cap + 1, d).index_put((slot,), xg[pt])
        bufs.append(buf[:-1].reshape(e, cap, d))
        combs.append((pt, pw, slot))
    buf = torch.stack(bufs, 1).reshape(e, g * cap, d)         # [E, G*C, d]
    out = swiglu_apply(p.experts, buf).reshape(e, g, cap, d)
    ys = []
    for gi, (pt, pw, slot) in enumerate(combs):
        flat_buf = out[:, gi].reshape(e * cap, d)
        got = torch.where((slot < e * cap)[:, None],
                          flat_buf[slot.clamp(0, e * cap - 1)], 0.0)
        ys.append(x.new_zeros(tl, d).index_add(
            0, pt, got * pw[:, None].to(x.dtype)))
    y = torch.stack(ys).reshape(b, s, d)
    if p.shared is not None:
        y = y + swiglu_apply(p.shared, x.reshape(t, d)).reshape(b, s, d)
    return y


def router_load(p: MoE, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """Expert load fractions for the aux-free bias update."""
    top_idx, _ = _route(p, cfg, x.reshape(-1, x.shape[-1]))
    counts = torch.bincount(top_idx.reshape(-1), minlength=cfg.n_experts)
    return counts.float() / counts.sum()


@torch.no_grad()
def update_router_bias(p: MoE, cfg: MoEConfig, load: torch.Tensor) -> MoE:
    """Aux-loss-free balancing: nudge the bias against over/under-loaded
    experts (DeepSeek-V3 eq. 16-17 sign update). Updates ``p`` in place
    (the reference returns a new pytree) and returns it."""
    target = 1.0 / cfg.n_experts
    p.router_bias.add_(cfg.bias_update_rate * torch.sign(target - load))
    return p
