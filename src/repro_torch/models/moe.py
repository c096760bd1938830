"""Mixture-of-Experts FFN, DeepSeek-V3 / Kimi-K2 style (twin of
``repro.models.moe``).

Shared expert(s) plus fine-grained routed experts with sigmoid top-k
routing and the aux-loss-free bias. Without a mesh, dispatch is
group-local as in the reference: tokens split into ``dispatch_groups``
groups, each sorted by expert (a stable sort, as ``jnp.argsort``),
clipped to a per-(group, expert) capacity ``C = T_local*k/E *
capacity_factor`` and scattered into expert slots; overflow tokens are
dropped (into a trash row that is sliced off, as the reference's
``mode="drop"`` scatter drops slot ``E*C``). The routed experts stay
stacked ``[E, ...]`` and run as one batched product.

With ``cfg.mesh`` set (``launch/steps.py`` sets it on every mesh cell,
even at mesh (1, 1)) the layer is the reference's expert-parallel
``_moe_shard_map``: each shard routes its local tokens, packs one send
buffer a destination shard (capacity ``c_send``), all-to-alls tokens
and local expert ids over the ``ep_axis`` group, regroups what it
received by local expert (capacity ``cap_e``), runs its experts and
reverses the path. Every sort is stable and every count a scatter into
a fixed-length buffer, so the path has no data-dependent shape and runs
on ``meta`` tensors.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..kernels.config import resolve_device
from ..launch.sharding import P, spec_of
from .layers import (Dense, SwiGLU, all_to_all, axis_size, psum,
                     shard_map, swiglu_apply, zeros)


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
    # distribution (set by launch/steps.py; None = single-device smoke)
    ep_axis: Any = None              # expert-parallel mesh axis ("model")
    # the reference's local path hints its layout with these two; the
    # port's local path runs on plain tensors, where a layout hint is the
    # identity, so they are accepted for parity and not read
    token_axes: Any = None           # token-shard axes, e.g. ("data","model")
    cap_axes: Any = None             # axes for the G*C slot dim (dp)
    dispatch_groups: int = 1         # G token groups, each routed alone
    mesh: Any = None                 # DeviceMesh => the shard_map EP path
    dp_axes: Any = None              # data axes of the mesh (shard_map)
    seq_axis: Any = None             # sequence-parallel axis of activations


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
    counts = _bucket_counts(pe, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    idx_in_e = torch.arange(tl * k, device=top_idx.device) - starts[pe]
    slot = torch.where(idx_in_e < cap, pe * cap + idx_in_e,
                       n_experts * cap)
    return pt, slot, order


def _bucket_counts(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.bincount(keys, length=n)`` for keys in [0, n), as a scatter
    into a fixed-length buffer."""
    keys = keys.long()
    return torch.zeros(n, dtype=torch.int64, device=keys.device
                       ).scatter_add_(0, keys, torch.ones_like(keys))


def _local_sort_dispatch(flat, keys, n_buckets: int, cap: int):
    """Sort-based bucketing of [T, d] rows by key into [n_buckets*cap, d].

    Returns (buf, order, slot) where ``slot[i]`` is the destination of the
    i-th *sorted* row (== n_buckets*cap when dropped) and ``order`` is the
    stable sort permutation. Negative keys mark empty slots: they are
    remapped past the last bucket, so they sort to the end and never
    shift a real bucket's positions. All ops are local (a ``shard_map``
    body's).
    """
    t = keys.shape[0]
    ks_remap = torch.where(keys < 0, n_buckets, keys).long()
    order = torch.argsort(ks_remap, stable=True)
    ks = ks_remap[order]
    counts = _bucket_counts(ks, n_buckets + 1)[:n_buckets]
    starts = torch.cumsum(counts, 0) - counts
    kc = ks.clamp(0, n_buckets - 1)
    idx = torch.arange(t, device=keys.device) - starts[kc]
    slot = torch.where((ks < n_buckets) & (idx < cap), kc * cap + idx,
                       n_buckets * cap)
    # one trash row takes the dropped rows, then is sliced off
    buf = flat.new_zeros(n_buckets * cap + 1, flat.shape[1]).index_put(
        (slot,), flat[order])
    return buf[:-1], order, slot


def _gather_rows(src, slot, n: int):
    """``where(slot < n, src[slot.clip(0, n - 1)], 0)`` row by row."""
    return torch.where((slot < n)[:, None], src[slot.clamp(0, n - 1)],
                       0.0)


def _moe_shard_map(p: MoE, cfg: MoEConfig, x):
    """Expert-parallel MoE with explicit all-to-alls under ``shard_map``.

    Layout: x is [B, S, d] sharded (dp_axes, seq_axis, None); routed
    experts are sharded over ``ep_axis`` (E_l = E / n_ep per shard). Two
    capacity stages (send and expert) drop overflow tokens, both local.
    """
    mesh = cfg.mesh
    ep = cfg.ep_axis
    n_ep = axis_size(mesh, ep)
    e, k = cfg.n_experts, cfg.top_k
    e_l = e // n_ep
    d = x.shape[-1]
    x_spec = P(cfg.dp_axes, cfg.seq_axis, None)
    experts = (p.experts.wg.w, p.experts.wu.w, p.experts.wd.w)
    exp_spec = P(ep, None, None)

    def inner(xl, wg, wu, wd, router_w, router_bias):
        bl, sl, _ = xl.shape
        tl = bl * sl
        flat = xl.reshape(tl, d)
        scores = torch.sigmoid(flat.to(cfg.router_dtype) @ router_w)
        biased = scores + router_bias[None, :]
        top_idx = torch.topk(biased, k, dim=1, sorted=True).indices
        top_w = torch.gather(scores, 1, top_idx)
        top_w = (top_w / (top_w.sum(1, keepdim=True) + 1e-9)
                 ).to(flat.dtype)
        pair_e = top_idx.reshape(-1)
        pair_t = torch.arange(tl, device=xl.device).repeat_interleave(k)
        pair_w = top_w.reshape(-1)
        dest = pair_e // e_l
        c_send = int(max(1, round(tl * k / n_ep * cfg.capacity_factor)))
        send_x, order, slot = _local_sort_dispatch(flat[pair_t], dest,
                                                   n_ep, c_send)
        send_le = torch.full((n_ep * c_send + 1,), -1, dtype=torch.int32,
                             device=xl.device).index_put(
            (slot,), (pair_e % e_l)[order].to(torch.int32))[:-1]
        r = n_ep * c_send
        rx = all_to_all(send_x, mesh, ep)
        rle = all_to_all(send_le, mesh, ep)
        cap_e = int(max(1, round(r / e_l * cfg.capacity_factor)))
        buf, order2, slot2 = _local_sort_dispatch(rx, rle, e_l, cap_e)
        h = buf.reshape(e_l, cap_e, d)
        out = (torch.nn.functional.silu(h @ wg.to(h.dtype))
               * (h @ wu.to(h.dtype))) @ wd.to(h.dtype)
        out = out.reshape(e_l * cap_e, d)
        back = flat.new_zeros(r, d).index_put(
            (order2,), _gather_rows(out, slot2, e_l * cap_e))
        ret = all_to_all(back, mesh, ep)
        got = _gather_rows(ret, slot, r)
        y = flat.new_zeros(tl, d).index_add(
            0, pair_t[order], got * pair_w[order][:, None])
        return y.reshape(bl, sl, d)

    y = shard_map(inner, mesh,
                  (x_spec, exp_spec, exp_spec, exp_spec, P(None, None),
                   P(None)), x_spec)(x, *experts, p.router.w,
                                     p.router_bias)
    if p.shared is not None:
        # token-local: operate on [B, S, d] directly
        y = y + swiglu_apply(p.shared, x)
    return y


def _moe_replicated(p: MoE, cfg: MoEConfig, x):
    """The local path on ``DTensor`` activations without mesh fields (the
    reference's batch-1 decode cells, which leave the layout to GSPMD).
    Routing, dispatch and combine run on every rank (a decode step's few
    tokens; DTensor has no rule for the dispatch's sorts and counts).
    The routed experts run where their weights lie: each rank takes the
    capacity slots of its own experts against its own weight shards (the
    model and hidden dimensions as the weights split them), and the
    partial products are summed (``psum``), so only activations cross
    ranks."""
    mesh = x.device_mesh
    e = p.experts
    rep = lambda t: P(*([None] * t.dim()))              # noqa: E731

    def dispatch(xl, rw, rb):
        lp = SimpleNamespace(router=SimpleNamespace(w=rw), router_bias=rb)
        return _dispatch_groups(lp, cfg, xl)

    routed = shard_map(dispatch, mesh,
                       (rep(x), rep(p.router.w), rep(p.router_bias)),
                       (P(None, None, None),) + (P(None, None),) * 3)(
        x, p.router.w, p.router_bias)
    e_ax, d_in, f_ax = spec_of(e.wg.w)
    d_out = spec_of(e.wd.w)[2]

    def axes(a) -> tuple:
        return () if a is None else (a,) if isinstance(a, str) else a

    def experts(bl, wg, wu, wd):
        g, u = bl @ wg.to(bl.dtype), bl @ wu.to(bl.dtype)
        for ax in axes(d_in):
            g, u = psum(g, mesh, ax), psum(u, mesh, ax)
        y = (torch.nn.functional.silu(g) * u) @ wd.to(bl.dtype)
        for ax in axes(f_ax):
            y = psum(y, mesh, ax)
        return y

    w_in = P(e_ax, d_in, f_ax)
    out = shard_map(experts, mesh,
                    (P(e_ax, None, d_in), w_in, w_in, P(e_ax, f_ax, d_out)),
                    P(e_ax, None, d_out))(routed[0], e.wg.w, e.wu.w, e.wd.w)
    y = shard_map(_combine_groups, mesh,
                  (P(None, None, None),) + (P(None, None),) * 3 + (rep(x),),
                  P(None, None, None))(out, *routed[1:], x)
    if p.shared is not None:
        b, s, d = x.shape
        y = y + swiglu_apply(p.shared, x.reshape(b * s, d)).reshape(b, s, d)
    return y


def _dispatch_groups(p, cfg: MoEConfig, x):
    """The local path's routing and dispatch: ``x`` [B, S, d] split into
    ``dispatch_groups`` groups, each routed and dispatched alone into
    [E, C] slots. Returns (buf [E, G*C, d], pt, pw, slot), the last three
    [G, T_local*k]: each sorted pair's token, weight and slot."""
    b, s, d = x.shape
    t = b * s
    g = max(1, cfg.dispatch_groups)
    if t % g != 0:   # ragged fallback (smoke shapes): single group
        g = 1
    tl = t // g
    e = cfg.n_experts
    cap = capacity(cfg, tl)
    bufs, pts, pws, slots = [], [], [], []
    for xg in x.reshape(g, tl, d):
        top_idx, top_w = _route(p, cfg, xg)
        pt, slot, order = _dispatch_slots(top_idx, cap, e)
        # one trash row takes the dropped pairs, then is sliced off
        buf = x.new_zeros(e * cap + 1, d).index_put((slot,), xg[pt])
        bufs.append(buf[:-1].reshape(e, cap, d))
        pts.append(pt)
        pws.append(top_w.reshape(-1)[order])
        slots.append(slot)
    buf = torch.stack(bufs, 1).reshape(e, g * cap, d)         # [E, G*C, d]
    return buf, torch.stack(pts), torch.stack(pws), torch.stack(slots)


def _combine_groups(out, pt, pw, slot, x):
    """The experts' output [E, G*C, d] back to [B, S, d]: each pair's
    slot row, weighted, added into its token (dropped pairs add 0)."""
    b, s, d = x.shape
    e, g = out.shape[0], pt.shape[0]
    cap, tl = out.shape[1] // g, b * s // g
    out = out.reshape(e, g, cap, d)
    ys = []
    for gi in range(g):
        flat_buf = out[:, gi].reshape(e * cap, d)
        got = torch.where((slot[gi] < e * cap)[:, None],
                          flat_buf[slot[gi].clamp(0, e * cap - 1)], 0.0)
        ys.append(x.new_zeros(tl, d).index_add(
            0, pt[gi], got * pw[gi][:, None].to(x.dtype)))
    return torch.stack(ys).reshape(b, s, d)


def moe_apply(p: MoE, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]."""
    if cfg.mesh is not None:
        return _moe_shard_map(p, cfg, x)
    if isinstance(x, DTensor):
        return _moe_replicated(p, cfg, x)
    b, s, d = x.shape
    buf, pt, pw, slot = _dispatch_groups(p, cfg, x)
    y = _combine_groups(swiglu_apply(p.experts, buf), pt, pw, slot, x)
    if p.shared is not None:
        y = y + swiglu_apply(p.shared, x.reshape(b * s, d)).reshape(b, s, d)
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
