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

The mesh paths' machinery lives here too: ``shard_map`` and the
collectives of its bodies (``psum``, ``pmax``, ``all_gather``,
``psum_scatter``, ``all_to_all`` over one mesh axis's group, each with
the reference's transpose), ``constrain`` (``with_sharding_constraint``)
and the layout-only helpers that steer DTensor outside the bodies
(``reshape``, ``einsum``, ``query_rows``, ``dense``'s weight gather).
On plain tensors every helper but ``shard_map`` is the plain op.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..kernels.config import resolve_device

DRAW_CHUNK = 1 << 26        # elements drawn at once (bounds the f32 temp)


# ----------------------------------------------------------- mesh paths
# The reference's mesh paths are ``jax.shard_map`` bodies (per-device
# programs with explicit collectives) inside a global GSPMD program, and
# ``with_sharding_constraint`` layout hints between them. Here the
# global program runs on ``DTensor``s (each op is DTensor's sharded
# twin, with the collectives DTensor inserts) and a ``shard_map`` body
# on each rank's local shards, with the collectives below over one
# mesh axis's process group. A body's gradient follows the reference's
# transpose rules (``check_vma=False``): an output's cotangent is
# divided by the sizes of the axes its spec leaves out, ``psum``
# transposes to ``psum``, ``all_gather`` to ``psum_scatter`` and back,
# ``all_to_all`` to itself, and an input's cotangent sums over the axes
# its spec leaves out (a ``Partial`` gradient).
def _spec_axes(spec) -> set:
    out = set()
    for entry in spec:
        if entry is not None:
            out.update((entry,) if isinstance(entry, str) else entry)
    return out


def _unmentioned(spec, mesh) -> list:
    """Mesh dimensions (indices) that ``spec`` does not shard over."""
    used = _spec_axes(spec)
    return [i for i, a in enumerate(mesh.mesh_dim_names) if a not in used]


def constrain(x, spec):
    """``jax.lax.with_sharding_constraint``: a ``DTensor`` redistributed
    to ``spec``'s placements on its own mesh (layout only, values
    unchanged); a plain tensor or a ``None`` spec is returned as is."""
    if spec is None or not isinstance(x, DTensor):
        return x
    from ..launch.sharding import placements
    return constrain_to(x, placements(spec, x.device_mesh))


def constrain_to(x, placements):
    """A ``DTensor`` redistributed to ``placements`` (layout only)."""
    if list(x.placements) == list(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def _view_blocks(src, dst) -> list:
    """Pair the dimensions of a reshape ``src -> dst`` into blocks of
    equal product: ``[(input dims, output dims)]``."""
    blocks, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        ins, outs = [i], [j]
        a = src[i] if i < len(src) else 1
        b = dst[j] if j < len(dst) else 1
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                a *= src[i]
                ins.append(i)
                i += 1
            else:
                b *= dst[j]
                outs.append(j)
                j += 1
        blocks.append(([d for d in ins if d < len(src)],
                       [d for d in outs if d < len(dst)]))
    return blocks


def _dtensor_reshape(x, shape):
    if -1 in shape:
        known = math.prod(d for d in shape if d != -1)
        shape = tuple(x.numel() // known if d == -1 else d for d in shape)
    mesh = x.device_mesh
    shards: dict = {}
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard):
            shards.setdefault(pl.dim, []).append(i)
    bad = set()
    for ins, outs in _view_blocks(tuple(x.shape), tuple(shape)):
        sharded = [d for d in ins if d in shards]
        if not sharded:
            continue
        if len(ins) == 1 and outs:
            n = math.prod(mesh.size(i) for i in shards[ins[0]])
            if shape[outs[0]] % n:
                bad.add(ins[0])
        elif len(ins) > 1:
            # a merge carries a sharded leading dimension only
            bad.update(d for d in sharded if d != ins[0])
    if bad:
        x = x.redistribute(mesh, [Replicate() if isinstance(pl, Shard)
                                  and pl.dim in bad else pl
                                  for pl in x.placements])
    return x.reshape(*shape)


def _split_letter(t, term: str, i: int):
    """The index letter of ``term`` that ``t`` is split on along mesh
    dimension ``i`` (None where it is whole or partial there)."""
    pl = t.placements[i]
    return term[pl.dim] if isinstance(pl, Shard) else None


def _sharded_einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` on ``DTensor``s as one einsum of the
    local shards. On each mesh dimension the operands are split on one
    index letter, or both whole: an operand split on a letter puts the
    other on the same letter where it has it (where both are split, on
    different letters, the larger keeps its split); the result is split
    there on that letter, or partial where the letter is summed away.
    DTensor's own einsum views its shards as one batched product, which
    a split on an inner dimension of the merged batch refuses (layout
    changes only)."""
    ta, tb, tc = eq.replace(" ", "").replace("->", ",").split(",")
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    a, b = (t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in (a, b))
    pa, pb, pc = [], [], []
    for i in range(mesh.ndim):
        la, lb = _split_letter(a, ta, i), _split_letter(b, tb, i)
        if la is not None and lb is not None and la != lb:
            if a.numel() >= b.numel():
                lb = None
            else:
                la = None
        ltr = la or lb
        pa.append(Shard(ta.index(ltr)) if ltr and ltr in ta else Replicate())
        pb.append(Shard(tb.index(ltr)) if ltr and ltr in tb else Replicate())
        pc.append(Replicate() if ltr is None else
                  Shard(tc.index(ltr)) if ltr in tc else Partial())
    a, b = constrain_to(a, pa), constrain_to(b, pb)
    size: dict = {}
    for term, t in ((ta, a), (tb, b)):      # a size-1 letter broadcasts
        for ltr, n in zip(term, t.shape):
            size[ltr] = max(n, size.get(ltr, 1))
    shape = tuple(size[ltr] for ltr in tc)
    stride = tuple(math.prod(shape[j + 1:]) for j in range(len(shape)))
    out = torch.einsum(eq, a.to_local(), b.to_local()).contiguous()
    return DTensor.from_local(out, mesh, pc, run_check=False, shape=shape,
                              stride=stride)


class _Einsum(torch.autograd.Function):
    """A two-operand einsum of ``DTensor``s whose forward and backward
    (two einsums; every index of an operand appears in another term) are
    each one einsum of the local shards (``_sharded_einsum``)."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.save_for_backward(a, b)
        ctx.terms = eq.replace(" ", "").replace("->", ",").split(",")
        return _sharded_einsum(eq, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ta, tb, tc = ctx.terms
        da = db = None
        if ctx.needs_input_grad[1]:
            da = _sharded_einsum(f"{tc},{tb}->{ta}", g, b)
        if ctx.needs_input_grad[2]:
            db = _sharded_einsum(f"{ta},{tc}->{tb}", a, g)
        return None, da, db


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)``. With a ``DTensor`` operand, forward and
    backward each run as one einsum of the local shards
    (``_sharded_einsum``), with no size-1 dimension sharded."""
    if not isinstance(a, DTensor) and not isinstance(b, DTensor):
        return torch.einsum(eq, a, b)
    return _Einsum.apply(eq, _unit_dims_whole(a), _unit_dims_whole(b))


def _unit_dims_whole(x):
    """A ``DTensor`` with no dimension of size 1 sharded (DTensor's
    einsum cannot flatten one away); other tensors as they are."""
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Shard) and x.shape[p.dim] == 1
            for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and x.shape[p.dim] == 1 else p
        for p in x.placements])


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _dtensor_reshape(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _dtensor_reshape(g, ctx.in_shape), None


def reshape(x, *shape):
    """``x.reshape(*shape)``. A ``DTensor`` dimension sharded in a way the
    reshape cannot carry (a split whose leading size the shard count does
    not divide; a merge whose inner dimension is sharded) is first
    replicated, in the forward and the backward pass: a layout change
    only, where DTensor has no rule."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _Reshape.apply(x, tuple(shape))


def take_rows(table, idx):
    """``table[idx]`` for an integer ``idx`` of any rank: the rows of the
    flat index, reshaped to ``idx.shape + table.shape[1:]`` (the same
    values). On ``DTensor``s a flat index is what torch 2.11's DTensor
    can differentiate: its ``index_put`` rule, the backward of a gather,
    computes a negative dimension for an index of two or more
    dimensions (layout only)."""
    if idx.dim() == 1:
        return table[idx]
    return reshape(table[reshape(idx, -1)], *idx.shape, *table.shape[1:])


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def shard_map(fn, mesh, in_specs, out_specs):
    """``jax.shard_map(fn, mesh, in_specs, out_specs, check_vma=False)``:
    each ``DTensor`` argument is redistributed to its spec and ``fn`` runs
    on this rank's local shards; each output (a tensor or a tuple of
    them) becomes a ``DTensor`` placed by its spec. A spec of ``None``
    passes the argument through untouched (a host value); a plain tensor
    argument beside ``DTensor``s is taken as replicated. At least one
    argument must be a ``DTensor`` (``sharding.distribute`` places a
    cell's arguments), on any mesh, one rank's included."""
    from ..launch.sharding import P, placements
    n_dims = len(mesh.mesh_dim_names)

    def local(a, spec):
        if spec is None or not torch.is_tensor(a):
            return a
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * n_dims,
                                   run_check=False)
        want = placements(spec, mesh)
        a = constrain_to(a, want)
        grad = list(want)
        for i in _unmentioned(spec, mesh):
            grad[i] = Partial()
        return a.to_local(grad_placements=grad)

    def wrap(o, spec):
        n = math.prod(mesh.size(i) for i in _unmentioned(spec, mesh))
        if n > 1 and o.requires_grad:
            o = _ScaleGrad.apply(o, 1.0 / n)
        return DTensor.from_local(o, mesh, placements(spec, mesh),
                                  run_check=False)

    def run(*args):
        if not any(isinstance(a, DTensor) for a in args):
            raise TypeError("shard_map needs DTensor arguments: place them "
                            "with sharding.distribute")
        out = fn(*(local(a, s) for a, s in zip(args, in_specs)))
        if not isinstance(out_specs, P):
            return tuple(wrap(o, s) for o, s in zip(out, out_specs))
        return wrap(out, out_specs)
    return run


def write_rows(dst, dim: int, start: int, src) -> None:
    """``dst[..., start:start + n, ...] = src`` along ``dim`` in place
    (``n = src.shape[dim]``; the reference's ``dynamic_update_slice``).
    On a ``DTensor`` whose ``dim`` is sharded, each rank writes the rows
    of ``src`` that fall in its own shard (``src`` whole along ``dim``,
    placed as ``dst`` elsewhere: layout only); a slice of a sharded
    dimension would be written into a gathered copy instead."""
    n = src.shape[dim]
    sharded = isinstance(dst, DTensor) and any(
        isinstance(pl, Shard) and pl.dim == dim for pl in dst.placements)
    if not sharded:
        dst.narrow(dim, start, n).copy_(src)
        return
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    want = [Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
            for pl in dst.placements]
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, dst.device_mesh,
                                 [Replicate()] * dst.device_mesh.ndim,
                                 run_check=False)
    src = constrain_to(src, want).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, dst.device_mesh, dst.placements)
    lo = max(start, offset[dim])
    hi = min(start + n, offset[dim] + shape[dim])
    if lo < hi:
        dst.to_local().narrow(dim, lo - offset[dim], hi - lo).copy_(
            src.narrow(dim, lo - start, hi - lo))


def _group(mesh, axis):
    return mesh.get_group(axis)


def axis_index(mesh, axis) -> int:
    """``lax.axis_index``: this rank's coordinate on mesh axis ``axis``."""
    return mesh.get_local_rank(axis)


def axis_size(mesh, axis) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


def _wait(t):
    return funcol.wait_tensor(t)


def _all_reduce(x, op: str, group):
    return _wait(funcol.all_reduce(x.contiguous(), op, group))


def _all_gather(x, dim: int, group):
    return _wait(funcol.all_gather_tensor(x.contiguous(), dim, group))


def _reduce_scatter(x, dim: int, group):
    return _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum", dim,
                                              group))


def _all_to_all(x, group):
    return _wait(funcol.all_to_all_single(x.contiguous(), None, None,
                                          group))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def psum(x, mesh, axis):
    """``lax.psum`` over one mesh axis (inside a ``shard_map`` body)."""
    return _Psum.apply(x, _group(mesh, axis))


def pmax(x, mesh, axis):
    """``lax.pmax`` of a value with no gradient (the reference takes it
    of a ``stop_gradient``)."""
    return _all_reduce(x.detach(), "max", _group(mesh, axis))


def all_gather(x, mesh, axis, dim: int):
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``."""
    return _AllGather.apply(x, dim, _group(mesh, axis))


def psum_scatter(x, mesh, axis, dim: int):
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``."""
    return _PsumScatter.apply(x, dim, _group(mesh, axis))


def all_to_all(x, mesh, axis):
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)``: dimension 0 split
    into one block a rank, block ``j`` sent to rank ``j``, the received
    blocks concatenated in rank order."""
    return _AllToAll.apply(x, _group(mesh, axis))


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


def _gathered_over_rows(w, x):
    """Under a mesh, the weight whole on every mesh axis that splits
    ``x``'s rows (any dimension but the last): ZeRO-3 style, activations
    stay sharded and the FSDP weight is gathered (the reference's
    ``_cst`` comment; GSPMD's choice there). Layout only."""
    if not isinstance(x, DTensor) or not isinstance(w, DTensor):
        return w
    want = [Replicate() if isinstance(xp, Shard) and xp.dim < x.dim() - 1
            else wp for xp, wp in zip(x.placements, w.placements)]
    return constrain_to(w, want)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    w = _gathered_over_rows(p.w, x).to(x.dtype)
    if isinstance(x, DTensor) and w.dim() == 2:
        # DTensor's matmul merges x's leading dimensions, which a split
        # on an inner one refuses: one einsum of the shards instead
        lead = "abcdefgh"[:x.dim() - 1]
        y = einsum(f"{lead}y,yz->{lead}z", x, w)
    else:
        y = x @ w
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
    qf = reshape(q, b, s, hk, g, d).float()
    qpos = torch.arange(s, device=q.device) + q_offset

    def body(m, l, acc, kblk, vblk, base):
        logits = einsum("bshgd,bchd->bshgc", qf, kblk.float()) * scale
        kpos = base + torch.arange(chunk, device=q.device)
        mask = (kpos[None, :] < t_valid).expand(s, chunk)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        logits = torch.where(mask[None, :, None, None, :], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + einsum("bshgc,bchd->bshgd", p,
                                                   vblk.float())
        return m_new, l, acc

    # the softmax state laid out as the queries are (under a mesh, a
    # plain tensor would be each rank's whole copy)
    m = torch.full_like(qf[..., 0], -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        m, l, acc = remat(body, m, l, acc, k[:, sl], v[:, sl], c * chunk)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return reshape(out, b, s, h, d).to(q.dtype)


def softmax(x):
    """``torch.softmax(x, -1)``. On a ``DTensor`` it runs as max, exp and
    sum, so that where the last dimension is split only the reductions'
    results cross ranks (DTensor's softmax gathers the dimension whole)."""
    if not isinstance(x, DTensor):
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _attend(qf, k, v, mask):
    """Softmax attention of f32 queries [B, S, Hkv, G, D] over k/v
    [B, T, Hkv, D] under ``mask`` [S, T] (or None) -> [B, S, Hkv, G, D]."""
    d = qf.shape[-1]
    logits = einsum("bshgd,bthd->bhgst", qf, k.float()) * (d ** -0.5)
    if mask is not None:
        logits = torch.where(mask[None, None, None], logits, -1e30)
    return einsum("bhgst,bthd->bshgd", softmax(logits), v.float())


def _sdpa(q, k, v, causal: bool, q_offset=None) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,T,Hkv,D] -> [B,S,H,D]; f32 softmax math.

    ``q_offset``: absolute position of the first query (causal masking
    of decode / chunked prefill where S != T); by default the mask is
    aligned at ``T - S``.
    """
    b, s, h, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    qf = reshape(q, b, s, hk, h // hk, d).float()
    mask = None
    if causal:
        off = q_offset if q_offset is not None else t - s
        qpos = torch.arange(s, device=q.device)[:, None] + off
        mask = torch.arange(t, device=q.device)[None, :] <= qpos
    return reshape(_attend(qf, k, v, mask), b, s, h, d).to(q.dtype)


def _masked_sdpa(q, k, v, mask) -> torch.Tensor:
    b, s, h, d = q.shape
    hk = k.shape[2]
    qf = reshape(q, b, s, hk, h // hk, d).float()
    return reshape(_attend(qf, k, v, mask), b, s, h, d).to(q.dtype)


def attn_qkv(p: Attention, cfg: AttnConfig, x, positions):
    """The projected, normed and rotated q [B,S,H,D], k, v [B,S,Hkv,D]
    that ``attn_apply`` attends with."""
    b, s, _ = x.shape
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = reshape(dense(p.wq, x), b, s, h, d)
    k = reshape(dense(p.wk, x), b, s, hk, d)
    v = reshape(dense(p.wv, x), b, s, hk, d)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def query_rows(x, *qkv):
    """Under a mesh, the layout attention runs in (layout only): queries
    split over the batch as ``x`` is and over their sequence on every
    other mesh axis; keys and values split over the batch alike, their
    sequence whole on each rank. Each rank then attends its own query
    rows, with no collective and no replicated work (the reference leaves
    this choice to GSPMD). Plain tensors are returned as they are."""
    q, *kv = qkv
    if not isinstance(q, DTensor):
        return qkv
    mesh = q.device_mesh
    pq, pkv = [], []
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            pq.append(Shard(0))
            pkv.append(Shard(0))
        else:
            pq.append(Shard(1) if q.shape[1] % mesh.size(i) == 0
                      else Replicate())
            pkv.append(Replicate())
    return (constrain_to(q, pq), *(constrain_to(t, pkv) for t in kv))


def attn_apply(p: Attention, cfg: AttnConfig, x: torch.Tensor,
               positions: torch.Tensor, kv_cache=None, causal: bool = True):
    """Returns (y, new_kv_cache). kv_cache = (k, v, length) with k/v
    [B, S_max, Hkv, D] and ``length`` an int, or None for the plain
    forward. The cache tensors are written in place and returned with
    ``length + S``."""
    b, s, _ = x.shape
    q, k, v = attn_qkv(p, cfg, x, positions)
    if kv_cache is None:
        q, k, v = query_rows(x, q, k, v)
        if s > cfg.attn_chunk:
            y = chunked_sdpa(q, k, v, causal=causal,
                             chunk=min(cfg.attn_chunk, s))
        else:
            y = _sdpa(q, k, v, causal=causal)
        new_cache = None
    else:
        ck, cv, length = kv_cache
        write_rows(ck, 1, length, k.to(ck.dtype))
        write_rows(cv, 1, length, v.to(cv.dtype))
        kpos = torch.arange(ck.shape[1], device=x.device)
        mask = (kpos[None, :] < length + s) \
            & (kpos[None, :] <= positions[:s, None])
        y = _masked_sdpa(q, ck, cv, mask)
        new_cache = (ck, cv, length + s)
    y = reshape(y, b, s, cfg.n_heads * cfg.head_dim)
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
