"""GCN and GIN message-passing layers (twin of ``repro.models.gnn``).

Message passing is a gather over an edge index and an ``index_add_``
(the reference's ``jax.ops.segment_sum``). Three execution modes:
full-batch (one scatter-add over all edges), sampled (fanout-bounded
neighbour blocks [B, fanout] from ``data.sampler``), and batched small
graphs (a disjoint union with a graph-id vector, sum-pooled).

The models do not call the port's packed-bitmap SpMM
(``kernels.ops.bitmap_spmm_op``); ``chip_smoke.py`` holds it against
``_aggregate``'s sum aggregation on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.config import resolve_device
from .layers import Dense, dense, take_rows, zeros


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                  # "gcn" | "gin"
    n_layers: int
    d_in: int
    d_hidden: int
    n_classes: int
    aggregator: str = "mean"   # gcn: sym-norm handled separately
    sym_norm: bool = True      # GCN D^-1/2 A D^-1/2
    learnable_eps: bool = True  # GIN
    dropout: float = 0.0
    param_dtype: Any = torch.float32


class GCNLayer(nn.Module):
    def __init__(self, gen, d_in, d_out, dtype, device):
        super().__init__()
        self.lin = Dense(gen, d_in, d_out, dtype, bias=True, device=device)


class GINLayer(nn.Module):
    """A 2-layer MLP per hop and the learnable ``eps`` (a scalar)."""

    def __init__(self, gen, d_in, d_out, dtype, device):
        super().__init__()
        self.mlp1 = Dense(gen, d_in, d_out, dtype, bias=True, device=device)
        self.mlp2 = Dense(gen, d_out, d_out, dtype, bias=True, device=device)
        self.eps = zeros((), dtype, device)


class GNN(nn.Module):
    """``gnn_init``: ``layers``, one ``GCNLayer`` or ``GINLayer`` per
    hop, d_in -> d_hidden ... -> n_classes."""

    def __init__(self, gen, cfg: GNNConfig, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        dims = ([cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1)
                + [cfg.n_classes])
        cls = GCNLayer if cfg.kind == "gcn" else GINLayer
        self.layers = nn.ModuleList(
            cls(gen, dims[i], dims[i + 1], cfg.param_dtype, device)
            for i in range(cfg.n_layers))


def gnn_init(gen, cfg: GNNConfig, device="cuda") -> GNN:
    return GNN(gen, cfg, device=device)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: out[i] = sum of data rows with id i."""
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def _aggregate(x, src, dst, n: int, deg, cfg: GNNConfig) -> torch.Tensor:
    """Scatter-add message passing: out[i] = reduce_{j->i} x[j] * coef."""
    msgs = x[src]
    if cfg.kind == "gcn" and cfg.sym_norm:
        coef = torch.rsqrt(torch.clamp(deg[src], min=1.0)) \
            * torch.rsqrt(torch.clamp(deg[dst], min=1.0))
        msgs = msgs * coef[:, None]
    agg = segment_sum(msgs, dst, n)
    if cfg.kind == "gcn" and not cfg.sym_norm and cfg.aggregator == "mean":
        agg = agg / torch.clamp(deg[:, None], min=1.0)
    return agg


def _layer_apply(layer, cfg: GNNConfig, h, agg, last: bool) -> torch.Tensor:
    if cfg.kind == "gcn":
        out = dense(layer.lin, agg)
    else:
        out = dense(layer.mlp2, F.relu(dense(layer.mlp1,
                                             (1.0 + layer.eps) * h + agg)))
    return out if last else F.relu(out)


def gnn_forward_full(params: GNN, cfg: GNNConfig, x, edge_index
                     ) -> torch.Tensor:
    """Full-batch forward. x: [N, d_in]; edge_index: int [2, E]
    (directed pairs; undirected graphs list both directions).
    Self-loops are added internally for GCN."""
    n = x.shape[0]
    src, dst = edge_index[0].long(), edge_index[1].long()
    if cfg.kind == "gcn":
        loops = torch.arange(n, device=src.device)
        src = torch.cat([src, loops])
        dst = torch.cat([dst, loops])
    deg = segment_sum(torch.ones(src.shape, device=src.device), dst, n)
    h = x
    for i, layer in enumerate(params.layers):
        agg = _aggregate(h, src, dst, n, deg, cfg)
        h = _layer_apply(layer, cfg, h, agg, last=(i == cfg.n_layers - 1))
    return h


def gnn_forward_sampled(params: GNN, cfg: GNNConfig, feats: list,
                        nbr_idx: list, nbr_valid: list) -> torch.Tensor:
    """Fanout-sampled forward (GraphSAGE-style blocks).

    feats[k]:     [N_k, d_in] features of layer-k nodes (N_0 = seeds).
    nbr_idx[k]:   int [N_k, fanout_k] indices into feats[k+1].
    nbr_valid[k]: bool [N_k, fanout_k].
    """
    h = list(feats)
    for i, layer in enumerate(params.layers):
        new_h = []
        for kk in range(cfg.n_layers - i):
            nbrs = take_rows(h[kk + 1], nbr_idx[kk].long())   # [N, f, d]
            valid = nbr_valid[kk][..., None].to(nbrs.dtype)
            if cfg.kind == "gcn":
                # include self in the normalised mean (A+I semantics)
                agg = ((nbrs * valid).sum(1) + h[kk]) / (valid.sum(1) + 1.0)
            elif cfg.aggregator == "mean":
                agg = (nbrs * valid).sum(1) / torch.clamp(valid.sum(1),
                                                          min=1.0)
            else:
                agg = (nbrs * valid).sum(1)
            new_h.append(_layer_apply(layer, cfg, h[kk], agg,
                                      last=(i == cfg.n_layers - 1)))
        h = new_h
    return h[0]


def gnn_forward_batched(params: GNN, cfg: GNNConfig, x, edge_index,
                        graph_id, n_graphs: int) -> torch.Tensor:
    """Disjoint-union batched small graphs -> per-graph logits via
    sum-pool readout (GIN-style)."""
    return segment_sum(gnn_forward_full(params, cfg, x, edge_index),
                       graph_id, n_graphs)


def gnn_loss(params: GNN, cfg: GNNConfig, x, edge_index, labels,
             mask=None) -> torch.Tensor:
    logits = gnn_forward_full(params, cfg, x, edge_index)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
