"""DIN (Deep Interest Network): target attention over a user's history
(twin of ``repro.models.recsys``).

The item and category tables are the hot path. ``embedding_bag`` is a
gather plus ``index_add_``, as the reference builds it from ``take`` and
``segment_sum``. Pointwise scoring takes [B] targets with [B, L]
histories; retrieval scores one user against N candidates with the
attention MLP batched over the candidate axis, materialising [N, L, 4F]
as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.config import resolve_device
from .gnn import segment_sum
from .layers import Dense, dense, normal, take_rows


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str
    n_items: int
    n_cats: int
    embed_dim: int = 18
    seq_len: int = 100
    attn_hidden: tuple = (80, 40)
    mlp_hidden: tuple = (200, 80)
    n_dense_feats: int = 8
    param_dtype: Any = torch.float32


class DIN(nn.Module):
    """``din_init``: ``item_table`` [n_items, d], ``cat_table``
    [n_cats, d] (std 0.01), the activation unit ``attn`` and the scoring
    ``mlp`` (lists of biased ``Dense``)."""

    def __init__(self, gen, cfg: DINConfig, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        d, dt = cfg.embed_dim, cfg.param_dtype
        feat = 2 * d                 # item + category embedding a position
        self.item_table = nn.Parameter(normal(gen, (cfg.n_items, d), 0.01,
                                              dt, device))
        self.cat_table = nn.Parameter(normal(gen, (cfg.n_cats, d), 0.01,
                                             dt, device))

        def mlp(dims):
            return nn.ModuleList(
                Dense(gen, dims[i], dims[i + 1], dt, bias=True,
                      device=device) for i in range(len(dims) - 1))
        # [hist, target, hist - target, hist * target] -> weight
        self.attn = mlp((4 * feat,) + cfg.attn_hidden + (1,))
        # pooled + target + profile -> logit
        self.mlp = mlp((2 * feat + cfg.n_dense_feats,) + cfg.mlp_hidden
                       + (1,))


def din_init(gen, cfg: DINConfig, device="cuda") -> DIN:
    return DIN(gen, cfg, device=device)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segment_ids: torch.Tensor, n_bags: int,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag from a gather and a scatter-add.

    indices: int [NNZ] rows of ``table``; segment_ids: int [NNZ] bag id
    per index (sorted not required). Returns [n_bags, d].
    """
    s = segment_sum(table[indices.long()], segment_ids, n_bags)
    if mode == "mean":
        cnt = segment_sum(torch.ones(indices.shape, device=table.device),
                          segment_ids, n_bags)
        s = s / torch.clamp(cnt[:, None], min=1.0)
    return s


def _mlp(layers, x, act=F.relu):
    for i, p in enumerate(layers):
        x = dense(p, x)
        if i < len(layers) - 1:
            x = act(x)
    return x


def _embed(p: DIN, item_ids, cat_ids) -> torch.Tensor:
    return torch.cat([take_rows(p.item_table, item_ids.long()),
                      take_rows(p.cat_table, cat_ids.long())], dim=-1)


def din_attention_pool(p: DIN, hist, target, mask) -> torch.Tensor:
    """hist: [..., L, F], target: [..., F] -> pooled [..., F].

    The DIN activation unit: a per-position MLP on [hist, target,
    hist - target, hist * target] gives a weight; the weighted sum (no
    softmax, per the paper) pools the history.
    """
    t = target[..., None, :].expand(hist.shape)
    z = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    w = _mlp(p.attn, z, act=torch.sigmoid)[..., 0] * mask
    return (hist * w[..., None]).sum(-2)


def din_forward(p: DIN, cfg: DINConfig, batch: dict) -> torch.Tensor:
    """Pointwise CTR scoring.

    batch: target_item/target_cat [B], hist_items/hist_cats [B, L],
    hist_mask [B, L], dense_feats [B, n_dense]. Returns [B] logits.
    """
    target = _embed(p, batch["target_item"], batch["target_cat"])
    hist = _embed(p, batch["hist_items"], batch["hist_cats"])
    pooled = din_attention_pool(p, hist, target, batch["hist_mask"])
    z = torch.cat([pooled, target, batch["dense_feats"]], dim=-1)
    return _mlp(p.mlp, z)[..., 0]


def din_score_candidates(p: DIN, cfg: DINConfig, user: dict, cand_items,
                         cand_cats) -> torch.Tensor:
    """Retrieval scoring: one user against N candidates -> [N] logits.

    user: hist_items/hist_cats [L], hist_mask [L], dense_feats [n_dense].
    The history embedding is computed once; the attention pool runs
    batched over the candidate axis.
    """
    hist = _embed(p, user["hist_items"], user["hist_cats"])   # [L, F]
    n = cand_items.shape[0]
    target = _embed(p, cand_items, cand_cats)                 # [N, F]
    pooled = din_attention_pool(
        p, hist[None].expand((n,) + hist.shape), target,
        user["hist_mask"][None].expand(n, hist.shape[0]))
    dense_b = user["dense_feats"][None].expand(n, -1)
    z = torch.cat([pooled, target, dense_b], dim=-1)
    return _mlp(p.mlp, z)[..., 0]


def din_loss(p: DIN, cfg: DINConfig, batch: dict) -> torch.Tensor:
    logits = din_forward(p, cfg, batch)
    labels = batch["labels"].float()
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))
