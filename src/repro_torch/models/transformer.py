"""Decoder-only transformer LM: dense / GQA / qk-norm / MLA / MoE (twin
of ``repro.models.transformer``).

One config covers the five LM architectures of the registry. The
reference stacks layer parameters on a leading axis and scans; the port
keeps one module per layer in ``LM.layers`` (``convert`` unstacks axis
0) and loops, recomputing each layer in the backward pass when
``cfg.remat`` is set and grad is enabled.

Entry points:
  * ``lm_init``          — the ``LM`` module.
  * ``lm_logits``        — training / prefill forward -> [B, S, V].
  * ``lm_loss``          — next-token CE loss (+ optional MTP loss).
  * ``init_decode_state``/``lm_decode_step`` — KV-cached decoding
    (latent cache when MLA is enabled). A step writes the caches in
    place; the state's ``length`` is a host int.

Under a mesh (``dp_axis`` / ``tp_axis`` / ``mesh`` set by
``launch/steps.py``; the parameters and inputs ``DTensor``s) the
activations are constrained to (dp, tp, None) between layers as the
reference's ``with_sharding_constraint`` calls do (``_cst``, a
``redistribute``), and the embedding lookup and the head's loss are the
reference's vocab-parallel ``shard_map`` bodies (``models.layers``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..kernels.config import resolve_device
from ..launch.sharding import P
from .layers import (AttnConfig, Attention, Dense, GeluMLP, SwiGLU,
                     all_gather, attn_apply, axis_index, axis_size,
                     constrain, dense, gelu_mlp_apply, normal, ones, pmax,
                     psum, psum_scatter, remat, rms_norm, shard_map,
                     swiglu_apply)
from .mla import MLA, MLAConfig, mla_decode_apply, mla_train_apply
from .moe import MoE, MoEConfig, moe_apply


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    mlp: str = "swiglu"                  # "swiglu" | "gelu"
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mtp: bool = False                    # DeepSeek-V3 multi-token predict
    mtp_weight: float = 0.3
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    # activation-sharding axes (set by launch/steps.py under a mesh;
    # None = no constraints, e.g. CPU smoke tests)
    dp_axis: Any = None
    tp_axis: Any = None
    mesh: Any = None          # DeviceMesh => vocab-parallel lookup / loss

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          n_kv_heads=self.n_kv_heads, head_dim=self.hd,
                          qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
                          rope_theta=self.rope_theta)

    def n_params(self) -> int:
        """Parameters of the matrices and the embedding / head (the
        reference's count: norms, biases, the router bias and the MTP
        block are left out)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        if self.mla is not None:
            m = self.mla
            attn = (d * m.d_cq + m.d_cq * m.n_heads * (m.d_nope + m.d_rope)
                    + d * m.d_c + d * m.d_rope
                    + m.d_c * m.n_heads * (m.d_nope + m.d_v)
                    + m.n_heads * m.d_v * d)
        else:
            attn = d * self.hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * self.hd * d
        if self.moe is not None:
            e = self.moe
            ffp = e.n_experts * 3 * d * e.d_ff_expert
            if e.n_shared:
                ffp += 3 * d * (e.d_ff_shared or e.d_ff_expert * e.n_shared)
            ffp += d * e.n_experts
        else:
            ffp = 3 * d * ff if self.mlp == "swiglu" else 2 * d * ff
        return self.n_layers * (attn + ffp) + 2 * v * d

    def n_active_params(self) -> int:
        """Activated parameters per token (MoE top-k)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        e = self.moe
        routed_all = self.n_layers * e.n_experts * 3 * d * e.d_ff_expert
        routed_act = self.n_layers * e.top_k * 3 * d * e.d_ff_expert
        return self.n_params() - routed_all + routed_act


# ------------------------------------------------------------------ init
class Block(nn.Module):
    """One layer (``_layer_init``): ``ln_attn``, ``attn`` (GQA or MLA),
    ``ln_ffn``, ``ffn`` (SwiGLU, GELU MLP or MoE)."""

    def __init__(self, gen, cfg: LMConfig, device):
        super().__init__()
        dt = cfg.param_dtype
        self.ln_attn = ones((cfg.d_model,), dt, device)
        self.ln_ffn = ones((cfg.d_model,), dt, device)
        if cfg.mla is not None:
            self.attn = MLA(gen, cfg.mla, dt, device=device)
        else:
            self.attn = Attention(gen, cfg.attn_cfg(), dt, device=device)
        if cfg.moe is not None:
            self.ffn = MoE(gen, cfg.d_model, cfg.moe, dt, device=device)
        elif cfg.mlp == "swiglu":
            self.ffn = SwiGLU(gen, cfg.d_model, cfg.d_ff, dt, device=device)
        else:
            self.ffn = GeluMLP(gen, cfg.d_model, cfg.d_ff, dt, device=device)


class MTP(nn.Module):
    """The multi-token-prediction head: ``proj`` [2d, d], a ``block``,
    and the norm ``ln``."""

    def __init__(self, gen, cfg: LMConfig, device):
        super().__init__()
        dt = cfg.param_dtype
        self.proj = Dense(gen, 2 * cfg.d_model, cfg.d_model, dt,
                          device=device)
        self.block = Block(gen, cfg, device)
        self.ln = ones((cfg.d_model,), dt, device)


class LM(nn.Module):
    """``lm_init``: ``embed`` [V, d] (std 0.02), ``layers`` (one ``Block``
    each), ``ln_final``, ``lm_head`` unless tied, ``mtp`` with
    ``cfg.mtp``."""

    def __init__(self, gen, cfg: LMConfig, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.embed = nn.Parameter(normal(gen, (cfg.vocab, cfg.d_model), 0.02,
                                         cfg.param_dtype, device))
        self.layers = nn.ModuleList(Block(gen, cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_final = ones((cfg.d_model,), cfg.param_dtype, device)
        self.lm_head = (None if cfg.tie_embeddings else
                        Dense(gen, cfg.d_model, cfg.vocab, cfg.param_dtype,
                              device=device))
        self.mtp = MTP(gen, cfg, device) if cfg.mtp else None


def lm_init(gen, cfg: LMConfig, device="cuda") -> LM:
    return LM(gen, cfg, device=device)


def _cst(x, cfg: LMConfig, *axes):
    """Batch-sharding constraint (ZeRO-3 style: activations stay sharded
    over data; FSDP weights are gathered instead)."""
    if cfg.dp_axis is None:
        return x
    return constrain(x, P(*axes))


def _embed_lookup(params: LM, cfg: LMConfig, tokens) -> torch.Tensor:
    """Vocab-parallel embedding lookup under a mesh: each model shard
    resolves its own vocab range and a ``psum_scatter`` over the
    sequence assembles the activations (the backward is a local scatter
    per shard)."""
    emb = params.embed
    v = emb.shape[0]
    mesh, tp = cfg.mesh, cfg.tp_axis
    if (mesh is None or tp is None or v % axis_size(mesh, tp) != 0
            or tokens.shape[1] % axis_size(mesh, tp) != 0):
        x = emb[tokens].to(cfg.compute_dtype)
        return _cst(x, cfg, cfg.dp_axis, cfg.tp_axis, None)

    def inner(emb_l, tok_l):
        vsh = emb_l.shape[0]
        lo = axis_index(mesh, tp) * vsh
        sel = tok_l.long() - lo
        ok = (sel >= 0) & (sel < vsh)
        out = torch.where(ok[..., None],
                          emb_l[sel.clamp(0, vsh - 1)].to(cfg.compute_dtype),
                          0)
        return psum_scatter(out, mesh, tp, 1)

    return shard_map(inner, mesh, (P(tp, None), P(cfg.dp_axis, None)),
                     P(cfg.dp_axis, tp, None))(emb, tokens)


# --------------------------------------------------------------- forward
def _ffn_apply(layer_p: Block, cfg: LMConfig, h) -> torch.Tensor:
    if cfg.moe is not None:
        return moe_apply(layer_p.ffn, cfg.moe, h)
    if cfg.mlp == "swiglu":
        return swiglu_apply(layer_p.ffn, h)
    return gelu_mlp_apply(layer_p.ffn, h)


def _block_apply(layer_p: Block, cfg: LMConfig, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, layer_p.ln_attn)
    if cfg.mla is not None:
        a = mla_train_apply(layer_p.attn, cfg.mla, h, positions)
    else:
        a, _ = attn_apply(layer_p.attn, cfg.attn_cfg(), h, positions)
    x = x + a
    return x + _ffn_apply(layer_p, cfg, rms_norm(x, layer_p.ln_ffn))


def _layer(layer_p: Block, cfg: LMConfig, x, positions) -> torch.Tensor:
    y = _block_apply(layer_p, cfg, x, positions)
    return _cst(y, cfg, cfg.dp_axis, cfg.tp_axis, None)


def _backbone(params: LM, cfg: LMConfig, tokens) -> torch.Tensor:
    # sequence-parallel activation sharding: what the backward saves per
    # layer is sharded over both the data axis (batch) and the model
    # axis (sequence)
    x = _embed_lookup(params, cfg, tokens)
    x = _cst(x, cfg, cfg.dp_axis, cfg.tp_axis, None)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for layer in params.layers:
        if cfg.remat:
            x = remat(_layer, layer, cfg, x, positions)
        else:
            x = _layer(layer, cfg, x, positions)
    return rms_norm(x, params.ln_final)


def _head(params: LM, cfg: LMConfig, x) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params.embed.to(x.dtype).T
    else:
        logits = dense(params.lm_head, x)
    return _cst(logits, cfg, cfg.dp_axis, cfg.tp_axis, None)


def lm_logits(params: LM, cfg: LMConfig, tokens) -> torch.Tensor:
    return _head(params, cfg, _backbone(params, cfg, tokens))


def _nll(logits, targets) -> torch.Tensor:
    lf = logits.float()
    gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return torch.logsumexp(lf, dim=-1) - gold


def _xent(logits, targets, mask=None) -> torch.Tensor:
    nll = _nll(logits, targets)
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def _vocab_parallel_nll(params: LM, cfg: LMConfig, h, targets
                        ) -> torch.Tensor:
    """Per-token NLL [B, S] of the head on ``h``. Under a mesh, the
    Megatron-style vocab-parallel head and cross entropy of the
    reference's ``shard_map``: each model shard holds a [d, V/tp] slice
    of the head, gathers its sequence once, computes the logits and the
    loss in ``n_tp`` sequence chunks (each recomputed in the backward),
    and only per-token sums cross shards."""
    mesh, tp = cfg.mesh, cfg.tp_axis
    w = params.lm_head.w if not cfg.tie_embeddings else None
    if (w is None or mesh is None or tp is None
            or cfg.vocab % axis_size(mesh, tp) != 0
            or h.shape[1] % (axis_size(mesh, tp) ** 2) != 0):
        return _nll(_head(params, cfg, h), targets)
    n_chunks = axis_size(mesh, tp)

    def chunk_nll(hx, tx, wl, lo):
        logits = (hx @ wl.to(hx.dtype)).float()
        # the running max is a numerical-stability shift only
        m = pmax(logits.amax(-1), mesh, tp)
        se = psum(torch.exp(logits - m[..., None]).sum(-1), mesh, tp)
        viota = torch.arange(logits.shape[-1], device=logits.device) + lo
        gold = torch.where(viota == tx[..., None].long(), logits,
                           0.0).sum(-1)
        gold = psum(gold, mesh, tp)
        return torch.log(se) + m - gold

    def inner(hl, wl, tl):
        hfull = all_gather(hl, mesh, tp, 1)                  # [B_l, S, d]
        lo = axis_index(mesh, tp) * wl.shape[1]
        c = hfull.shape[1] // n_chunks
        return torch.cat([
            remat(chunk_nll, hfull[:, i * c:(i + 1) * c],
                  tl[:, i * c:(i + 1) * c], wl, lo)
            for i in range(n_chunks)], dim=1)

    return shard_map(inner, mesh,
                     (P(cfg.dp_axis, tp, None), P(None, tp),
                      P(cfg.dp_axis, None)),
                     P(cfg.dp_axis, None))(h, w, targets)


def lm_loss(params: LM, cfg: LMConfig, batch: dict) -> torch.Tensor:
    """batch: {"tokens": [B, S], "targets": [B, S]} (targets = next ids).

    With ``cfg.mtp`` adds the DeepSeek-style one-step-ahead MTP loss.
    """
    targets = batch["targets"]
    h = _backbone(params, cfg, batch["tokens"])
    loss = _vocab_parallel_nll(params, cfg, h, targets).mean()
    if cfg.mtp:
        def mtp_loss(h):
            # predict t+2: combine h_t with the embedding of target t+1
            emb_next = _embed_lookup(params, cfg, targets)
            z = torch.cat([rms_norm(h, params.mtp.ln), emb_next], dim=-1)
            z = dense(params.mtp.proj, z)
            z = _cst(z, cfg, cfg.dp_axis, cfg.tp_axis, None)
            z = _block_apply(params.mtp.block, cfg, z,
                             torch.arange(z.shape[1], device=z.device))
            t2 = torch.cat([targets[:, 1:], targets[:, -1:]], dim=1)
            return _vocab_parallel_nll(params, cfg, z, t2)[:, :-1].mean()
        mtp = remat(mtp_loss, h) if cfg.remat else mtp_loss(h)
        loss = loss + cfg.mtp_weight * mtp
    return loss


# ---------------------------------------------------------------- decode
def init_decode_state(cfg: LMConfig, batch: int, s_max: int,
                      device="cuda") -> dict:
    """Per-layer caches stacked on a leading layer axis, as the
    reference's: (k, v, lens) [L, B, S_max, Hkv, D], or the latent
    (c [L, B, S_max, d_c], r [L, B, S_max, d_rope], lens) with MLA."""
    device = resolve_device(device)
    dt, n = cfg.compute_dtype, cfg.n_layers
    if cfg.mla is not None:
        shapes = ((n, batch, s_max, cfg.mla.d_c),
                  (n, batch, s_max, cfg.mla.d_rope))
    else:
        shapes = ((n, batch, s_max, cfg.n_kv_heads, cfg.hd),) * 2
    caches = tuple(torch.zeros(sh, dtype=dt, device=device) for sh in shapes)
    lens = torch.zeros((n,), dtype=torch.int32, device=device)
    return {"cache": (*caches, lens), "length": 0}


def lm_decode_step(params: LM, cfg: LMConfig, tokens, state: dict
                   ) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: [B, S_step] (S_step typically 1). Writes
    the step's keys into ``state``'s caches in place and returns the
    logits and the state with ``length + S_step``."""
    s = tokens.shape[1]
    x = _embed_lookup(params, cfg, tokens)
    length = state["length"]
    positions = length + torch.arange(s, device=tokens.device)
    c0, c1, _ = state["cache"]
    for i, layer_p in enumerate(params.layers):
        h = rms_norm(x, layer_p.ln_attn)
        if cfg.mla is not None:
            a, _ = mla_decode_apply(layer_p.attn, cfg.mla, h,
                                    (c0[i], c1[i], length))
        else:
            a, _ = attn_apply(layer_p.attn, cfg.attn_cfg(), h, positions,
                              kv_cache=(c0[i], c1[i], length))
        x = x + a
        x = x + _ffn_apply(layer_p, cfg, rms_norm(x, layer_p.ln_ffn))
    logits = _head(params, cfg, rms_norm(x, params.ln_final))
    return logits, {"cache": state["cache"], "length": length + s}
