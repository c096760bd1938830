"""E(3)-equivariant interatomic potentials: NequIP-lite and MACE-lite
(twin of ``repro.models.equivariant``).

Irreps in Cartesian form, as the reference carries them (exact for
l <= 2): scalars s [N, C], vectors v [N, C, 3], traceless symmetric
T [N, C, 3, 3]. Nine tensor-product message paths, each gated by a
radial MLP of a Bessel basis; per-order channel mixing; nonlinearities
on scalars and gates only. MACE-lite adds products of the aggregated
features (correlation order 3).

Forces are ``-dE/dpos`` by ``torch.autograd.grad``. While grad is
enabled at the call (training), the force graph is kept
(``create_graph=True``) so a loss on forces can be differentiated; under
``torch.no_grad()`` (serving) it is not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.config import resolve_device
from .gnn import segment_sum
from .layers import Dense, dense, einsum, normal, remat, reshape

_N_PATHS = 9   # tensor-product paths of _edge_messages


@dataclasses.dataclass(frozen=True)
class EquivConfig:
    name: str
    kind: str                  # "nequip" | "mace"
    n_layers: int
    channels: int
    n_species: int = 8
    n_rbf: int = 8
    cutoff: float = 5.0
    l_max: int = 2             # fixed 2 in this implementation
    correlation: int = 1       # MACE: 3
    param_dtype: Any = torch.float32
    # 0 = all edge messages at once; >0 = edges in chunks of this many,
    # each chunk's messages recomputed in the backward pass
    edge_chunk: int = 0


# ----------------------------------------------------------- radial basis
def bessel_basis(r: torch.Tensor, n: int, cutoff: float) -> torch.Tensor:
    """Sinc-like Bessel radial basis with smooth polynomial cutoff."""
    rs = torch.clamp(r, min=1e-9)[..., None]
    k = torch.arange(1, n + 1, dtype=torch.float32,
                     device=r.device) * math.pi / cutoff
    basis = math.sqrt(2.0 / cutoff) * torch.sin(k * rs) / rs
    x = torch.clamp(r / cutoff, 0.0, 1.0)[..., None]
    env = 1.0 - 10.0 * x ** 3 + 15.0 * x ** 4 - 6.0 * x ** 5  # C^2 envelope
    return basis * env


def _traceless_sym(m: torch.Tensor) -> torch.Tensor:
    """Project [..., 3, 3] onto traceless-symmetric (the l=2 rep)."""
    sym = 0.5 * (m + m.transpose(-1, -2))
    eye = torch.eye(3, device=m.device, dtype=m.dtype)
    # the trace as a masked sum: DTensor has no rule for the backward of
    # ``diagonal``
    tr = (sym * eye).sum((-2, -1))[..., None, None]
    return sym - tr * eye / 3.0


# ----------------------------------------------------------------- layers
class EquivLayer(nn.Module):
    """``_layer_init``: the radial MLP (``rad1``, ``rad2``), the
    per-order channel mixers (``mix_s``, ``mix_v``, ``mix_t``) and the
    ``gate``."""

    def __init__(self, gen, cfg: EquivConfig, device):
        super().__init__()
        c, dt = cfg.channels, cfg.param_dtype
        pair = 2 if cfg.correlation >= 2 else 1
        d_s = (c * (3 if cfg.correlation >= 2 else 1)
               + (3 * c if cfg.correlation >= 3 else 0))
        self.rad1 = Dense(gen, cfg.n_rbf, 32, dt, True, device=device)
        self.rad2 = Dense(gen, 32, _N_PATHS * c, dt, True, device=device)
        self.mix_s = Dense(gen, d_s, c, dt, True, device=device)
        self.mix_v = Dense(gen, c * pair, c, dt, device=device)
        self.mix_t = Dense(gen, c * pair, c, dt, device=device)
        self.gate = Dense(gen, c, 2 * c, dt, True, device=device)


class Equiv(nn.Module):
    """``equiv_init``: ``species_embed`` [n_species, C] (std 0.5),
    ``layers``, ``readout1`` [C, C], ``readout2`` [C, 1]."""

    def __init__(self, gen, cfg: EquivConfig, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        dt = cfg.param_dtype
        self.species_embed = nn.Parameter(normal(
            gen, (cfg.n_species, cfg.channels), 0.5, dt, device))
        self.layers = nn.ModuleList(EquivLayer(gen, cfg, device)
                                    for _ in range(cfg.n_layers))
        self.readout1 = Dense(gen, cfg.channels, cfg.channels, dt, True,
                              device=device)
        self.readout2 = Dense(gen, cfg.channels, 1, dt, True, device=device)


def equiv_init(gen, cfg: EquivConfig, device="cuda") -> Equiv:
    return Equiv(gen, cfg, device=device)


def _messages(layer: EquivLayer, cfg: EquivConfig, s, v, T, src, dst,
              rvec, n: int):
    """One tensor-product message sweep + aggregation.

    rvec: [E, 3] displacement of each edge (dst <- src). Returns the
    aggregated (As, Av, AT), each [N, C, ...]. With ``cfg.edge_chunk``
    set, edges go through in chunks whose messages are recomputed in
    the backward pass; the last chunk is padded as in the reference
    (source 0, displacement (1, 1, 1), weight 0).
    """
    e_total = src.shape[0]
    ck = cfg.edge_chunk
    if ck and e_total > ck:
        pad = -(-e_total // ck) * ck - e_total
        srcp = F.pad(src, (0, pad))
        dstp = F.pad(dst, (0, pad))
        validp = F.pad(torch.ones(e_total, device=src.device), (0, pad))
        rvecp = torch.cat([rvec, rvec.new_ones((pad, 3))])

        def body(As, Av, AT, sc, dc, rv, va):
            ms, mv, mT = _edge_messages(layer, cfg, s, v, T, sc, rv)
            w = va.to(ms.dtype)
            return (As + segment_sum(ms * w[:, None], dc, n),
                    Av + segment_sum(mv * w[:, None, None], dc, n),
                    AT + segment_sum(mT * w[:, None, None, None], dc, n))

        acc = (s.new_zeros((n, cfg.channels)),
               s.new_zeros((n, cfg.channels, 3)),
               s.new_zeros((n, cfg.channels, 3, 3)))
        for i in range(0, e_total + pad, ck):
            sl = slice(i, i + ck)
            acc = remat(body, *acc, srcp[sl], dstp[sl], rvecp[sl],
                        validp[sl])
        return acc
    m_s, m_v, m_T = _edge_messages(layer, cfg, s, v, T, src, rvec)
    return (segment_sum(m_s, dst, n), segment_sum(m_v, dst, n),
            segment_sum(m_T, dst, n))


def _edge_messages(layer: EquivLayer, cfg: EquivConfig, s, v, T, src,
                   rvec):
    """Per-edge tensor-product messages (no aggregation)."""
    c = cfg.channels
    r = torch.linalg.norm(rvec, dim=-1)                      # [E]
    rhat = rvec / torch.clamp(r, min=1e-9)[:, None]          # [E, 3]
    rbf = bessel_basis(r, cfg.n_rbf, cfg.cutoff)             # [E, nrbf]
    w = dense(layer.rad2, F.silu(dense(layer.rad1, rbf)))
    w = reshape(w, -1, _N_PATHS, c)                          # [E, P, C]

    s_j, v_j, T_j = s[src], v[src], T[src]
    Y2 = _traceless_sym(rhat[:, None, :] * rhat[:, :, None])  # [E, 3, 3]

    # scalar messages: (0x0->0), (1x1->0), (2x2->0)
    m_s = (w[:, 0] * s_j
           + w[:, 1] * einsum("eci,ei->ec", v_j, rhat)
           + w[:, 2] * einsum("ecij,eij->ec", T_j, Y2))
    # vector messages: (0x1->1), (1x0->1), (2x1->1)
    m_v = (w[:, 3, :, None] * s_j[:, :, None] * rhat[:, None, :]
           + w[:, 4, :, None] * v_j
           + w[:, 5, :, None] * einsum("ecij,ej->eci", T_j, rhat))
    # tensor messages: (0x2->2), (1x1->2), (2x0->2)
    outer_vr = _traceless_sym(v_j[..., :, None] * rhat[:, None, None, :])
    m_T = (w[:, 6, :, None, None] * s_j[:, :, None, None] * Y2[:, None]
           + w[:, 7, :, None, None] * outer_vr
           + w[:, 8, :, None, None] * T_j)
    return m_s, m_v, m_T


def _update(layer: EquivLayer, cfg: EquivConfig, s, v, T, As, Av, AT):
    """Equivariant update with the optional MACE higher-order products."""
    s_feats, v_feats, t_feats = [As], [Av], [AT]
    if cfg.correlation >= 2:      # two-body products of aggregates
        at_av = einsum("ncij,ncj->nci", AT, Av)
        s_feats += [einsum("nci,nci->nc", Av, Av),
                    einsum("ncij,ncij->nc", AT, AT)]
        v_feats += [at_av]
        t_feats += [_traceless_sym(Av[..., :, None] * Av[..., None, :])]
    if cfg.correlation >= 3:      # three-body invariants
        s_feats += [As * As,
                    As * einsum("nci,nci->nc", Av, Av),
                    einsum("nci,nci->nc", Av, at_av)]
    s_new = dense(layer.mix_s, torch.cat(s_feats, dim=-1))
    v_new = einsum("nki,kc->nci", torch.cat(v_feats, dim=1),
                         layer.mix_v.w)
    T_new = einsum("nkij,kc->ncij", torch.cat(t_feats, dim=1),
                         layer.mix_t.w)
    # gated nonlinearity: scalars gate the higher orders
    gates = torch.sigmoid(dense(layer.gate, F.silu(s_new)))
    gv, gt = gates[..., :cfg.channels], gates[..., cfg.channels:]
    return (s + F.silu(s_new),
            v + v_new * gv[..., None],
            T + T_new * gt[..., None, None])


def equiv_node_energies(params: Equiv, cfg: EquivConfig, species,
                        positions, edge_index) -> torch.Tensor:
    """Per-node energy contributions [N] (for batched graphs)."""
    n = species.shape[0]
    src, dst = edge_index[0].long(), edge_index[1].long()
    rvec = positions[src] - positions[dst]
    s = params.species_embed[species.long()]
    v = s.new_zeros((n, cfg.channels, 3))
    T = s.new_zeros((n, cfg.channels, 3, 3))
    for layer in params.layers:
        As, Av, AT = _messages(layer, cfg, s, v, T, src, dst, rvec, n)
        s, v, T = _update(layer, cfg, s, v, T, As, Av, AT)
    return dense(params.readout2, F.silu(dense(params.readout1, s)))[:, 0]


def equiv_energy(params: Equiv, cfg: EquivConfig, species, positions,
                 edge_index) -> torch.Tensor:
    """Total energy. species: int [N]; positions: [N, 3];
    edge_index: [2, E] (both directions for undirected neighbour lists)."""
    return equiv_node_energies(params, cfg, species, positions,
                               edge_index).sum()


def _neg_grad(out: torch.Tensor, positions: torch.Tensor, create_graph):
    return -torch.autograd.grad(out, positions,
                                create_graph=create_graph)[0]


def _with_grad(positions: torch.Tensor) -> torch.Tensor:
    return positions if positions.requires_grad else \
        positions.detach().requires_grad_(True)


def equiv_forces(params: Equiv, cfg: EquivConfig, species, positions,
                 edge_index) -> tuple[torch.Tensor, torch.Tensor]:
    """(energy, forces = -dE/dpos) — the standard potential interface."""
    keep = torch.is_grad_enabled()
    with torch.enable_grad():
        pos = _with_grad(positions)
        e = equiv_energy(params, cfg, species, pos, edge_index)
        f = _neg_grad(e, pos, keep)
    return (e, f) if keep else (e.detach(), f)


def equiv_batched_loss(params: Equiv, cfg: EquivConfig, batch: dict,
                       n_graphs: int) -> torch.Tensor:
    """Disjoint-union molecular batch: per-graph energy MSE (+forces)."""
    keep = torch.is_grad_enabled()
    with torch.enable_grad():
        pos = _with_grad(batch["positions"])
        e_node = equiv_node_energies(params, cfg, batch["species"], pos,
                                     batch["edge_index"])
        e_graphs = segment_sum(e_node, batch["graph_id"], n_graphs)
        loss = ((e_graphs - batch["energy"]) ** 2).mean()
        if "forces" in batch:
            forces = _neg_grad(e_graphs.sum(), pos, True)
            loss = loss + ((forces - batch["forces"]) ** 2).mean()
    return loss if keep else loss.detach()


def equiv_energy_loss(params: Equiv, cfg: EquivConfig, batch: dict
                      ) -> torch.Tensor:
    """Squared error of the total energy (+ the forces' MSE)."""
    e, f = equiv_forces(params, cfg, batch["species"], batch["positions"],
                        batch["edge_index"])
    loss = (e - batch["energy"]) ** 2
    if "forces" in batch:
        loss = loss + ((f - batch["forces"]) ** 2).mean()
    return loss
