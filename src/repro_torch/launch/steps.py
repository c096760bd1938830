"""Per-(arch x shape) step builders (twin of ``repro.launch.steps``).

``build_cell(arch_id, shape_name, mesh)`` returns a :class:`Cell`: the
step function, its arguments as ``meta`` tensors (shapes and dtypes,
never allocated; the twin of ``ShapeDtypeStruct``), their partition
specs and the output's, and donation info. The argument trees are the
reference's, leaf for leaf: a model's parameters and optimizer state
are the reference-shaped trees ``convert.lm_tree`` / ``gnn_tree`` /
``opt_tree`` give, and packed bitmap words are int32 where the
reference has uint32 (the port's convention).

What the steps do on real tensors, family by family:

* GNN, equivariant and DIN cells run the port's models: ``fn`` binds the
  parameter tree's tensors to the model (no copy), runs the loss or the
  forward, and for a train step its backward and ``adamw_update``. The
  donated parameter and optimizer trees (``donate``) are updated in
  place and returned, as the reference's donated buffers are;
* the matcher cells run ``expand_wave_mq`` and ``run_device_megastep``
  (the Δ store and stack banks are updated in place and returned in the
  reference's output positions); :func:`matcher_args` builds real inputs
  for them, on either adjacency layout. On ``DTensor``s a matcher step
  runs on each rank's local tensors (:func:`_matcher_on_mesh`): the
  adjacency rows (the dense block or the hier summary) stay split over
  ``model``, everything else is gathered whole, and every rank runs the
  single-device step in its order, the same loop, readbacks and
  collectives; only Eq. 2 divides its work (``engine_step``'s split
  refine, on each rank's own rows, ANDed across ``model``);
* the LM cells run the models' mesh paths: ``fn`` builds the config
  with the mesh fields the reference sets (``Cell.static["cfg"]``; the
  fields alone in ``Cell.static["mesh_fields"]``), binds the parameter
  tree (``bind_lm``; each layer a view of its stacked leaf) and runs
  ``lm_loss``, its backward and ``adamw_update`` in place; ``lm_logits``;
  or one ``lm_decode_step`` writing the donated caches in place (the
  state's 0-d ``length`` is read as the host int the port's decode takes,
  0 on ``meta``, and advanced in place). :func:`example_args` draws valid
  inputs for them.

Under a mesh the arguments are ``DTensor``s placed by ``in_specs``
(``sharding.distribute``), at mesh (1, 1) too; an LM cell's ``fn`` on
plain tensors raises. The ``shard_map`` bodies run
the reference's collectives (``models.layers``). Outside them DTensor
places each op; these steps steer it and are layout only (values
unchanged, no collective of a reference ``shard_map`` body replaced):

* ``layers.constrain`` — the reference's ``with_sharding_constraint``;
* ``layers.reshape`` — replicates a dimension a reshape cannot carry
  sharded (a split whose leading size the shard count does not divide,
  a merge with a sharded inner dimension; GQA's head split);
* ``layers.einsum`` (and ``dense``'s product) — one einsum of the local
  shards: on each mesh axis an operand takes the other's split letter
  (or, split on another, the smaller is), no size-1 dimension split;
* ``layers.softmax`` — max, exp and sum, so a split last dimension stays
  split (only the reductions' results cross ranks);
* ``layers.write_rows`` — a decode step's cache rows, each rank writing
  the rows of its own sequence shard;
* ``moe._moe_replicated`` — a batch-1 decode step's routing and combine
  on every rank, its experts where their weights lie;
* ``layers.query_rows`` — attention's queries split over batch and
  sequence, keys and values over batch only (GQA's ``attn_apply`` and
  MLA's prefill chunks);
* ``layers.dense``'s weight, gathered over every mesh axis that splits
  the activations' rows (ZeRO-3);
* ``_grad_like`` — each gradient in its parameter's layout before
  AdamW.

DTensor ranks candidate layouts under ``sharding.greedy_layout_search``
(``_spmd``). There is no ``Cell.lower``: the dry-run
(``launch.dryrun``) counts a run of ``fn`` on ``meta`` arguments
(``roofline.hlo_cost``) instead of compiling.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from .. import convert
from ..configs.common import ArchSpec, ShapeCell
from ..configs.registry import get_arch
from ..models import gnn, recsys
from ..models.equivariant import (Equiv, equiv_batched_loss,
                                  equiv_energy_loss)
from ..models.gnn import GNN
from ..models.recsys import DIN
from ..models.transformer import (init_decode_state, lm_decode_step,
                                  lm_init, lm_logits, lm_loss)
from ..training.optimizer import AdamWConfig, adamw_init, adamw_update
from .mesh import axis_sizes, dp_axes
from .sharding import (P, _axis_size, _sanitize, dp, greedy_layout_search,
                       opt_specs, param_specs, placements,
                       tree_leaves_with_path, tree_map, tree_map_with_path)

def meta(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype placeholder (``jax.ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree``."""
    return sum(t.numel() * t.element_size()
               for _, t in tree_leaves_with_path(tree))


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    fn: Callable
    args: tuple                  # meta-tensor trees
    in_specs: tuple              # P trees
    out_specs: Any
    donate: tuple = ()
    static: dict | None = None

    def arg_bytes(self) -> int:
        return tree_bytes(self.args)


def _opt_cfg(spec: ArchSpec) -> AdamWConfig:
    big = spec.family == "lm" and spec.config.n_params() > 1e11
    return AdamWConfig(state_dtype=torch.bfloat16 if big else torch.float32)


# ====================================================================== LM
def _lm_mesh_fields(cfg, mesh, batch_div: bool,
                    seq_axis: str | None) -> dict:
    """The mesh fields the reference sets on the config (``dp_axis``,
    ``tp_axis``, ``mesh`` and the MoE / MLA ones)."""
    if not batch_div:
        return {}
    dpa = dp(mesh)
    tp = "model" if seq_axis else None
    fields: dict = {"dp_axis": dpa, "tp_axis": tp, "mesh": mesh}
    if cfg.moe:
        fields["moe"] = {"ep_axis": "model", "mesh": mesh, "dp_axes": dpa,
                         "seq_axis": seq_axis}
    if cfg.mla:
        fields["mla"] = {"dp_axis": dpa, "tp_axis": tp}
    return fields


def _with_fields(cfg, fields: dict):
    """``cfg`` with the mesh fields set, the MoE / MLA ones on their
    sub-configs."""
    over = {k: v for k, v in fields.items() if k not in ("moe", "mla")}
    for sub in ("moe", "mla"):
        if sub in fields:
            over[sub] = dataclasses.replace(getattr(cfg, sub), **fields[sub])
    return dataclasses.replace(cfg, **over)


def _lm_param_trees(spec: ArchSpec, mesh, batch_div: bool = True,
                    seq_axis: str | None = "model"):
    fields = _lm_mesh_fields(spec.config, mesh, batch_div, seq_axis)
    cfg = _with_fields(spec.config, fields)
    model = lm_init(None, cfg, device="meta")
    pshape = convert.lm_tree(model)
    pspec = param_specs(pshape, mesh, "lm")
    ocfg = _opt_cfg(spec)
    oshape = convert.opt_tree(adamw_init(convert.ref_order(model), ocfg),
                              model)
    ospec = opt_specs(oshape, pspec)
    return cfg, fields, pshape, pspec, oshape, ospec, ocfg


def bind_lm(cfg, params) -> nn.Module:
    """An ``LM`` of ``cfg`` whose parameters are the reference-shaped
    tree ``params``' tensors (each layer a view of its stacked leaf)."""
    return _bind(lm_init(None, cfg, device="meta"), params, ("layers",))


def _lm_train_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    cfg, fields, pshape, pspec, oshape, ospec, ocfg = _lm_param_trees(
        spec, mesh)
    b = cell.dims["global_batch"]
    s = cell.dims["seq_len"]
    batch = {"tokens": meta((b, s), torch.int32),
             "targets": meta((b, s), torch.int32)}
    bspec = {"tokens": P(dp(mesh), None), "targets": P(dp(mesh), None)}
    fn = _train_fn(lambda: lm_init(None, cfg, device="meta"),
                   lambda m, bt: lm_loss(m, cfg, bt), ocfg, ("layers",))
    return Cell(spec.arch_id, cell.name, fn,
                (pshape, oshape, batch), (pspec, ospec, bspec),
                (pspec, ospec, P()), donate=(0, 1),
                static={"mesh_fields": fields, "cfg": cfg})


def _lm_prefill_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    cfg, fields, pshape, pspec, *_ = _lm_param_trees(spec, mesh)
    b = cell.dims["global_batch"]
    s = cell.dims["seq_len"]
    tokens = meta((b, s), torch.int32)

    @torch.no_grad()
    def prefill(params, tokens):
        with _spmd():
            return lm_logits(bind_lm(cfg, params), cfg, tokens)

    return Cell(spec.arch_id, cell.name, prefill,
                (pshape, tokens), (pspec, P(dp(mesh), None)),
                P(dp(mesh), None, "model"),
                static={"mesh_fields": fields, "cfg": cfg})


def _host_length(length) -> int:
    """The decode state's 0-d ``length`` as the host int the port's decode
    step takes (0 on ``meta``, where only shapes count)."""
    if isinstance(length, DTensor):
        length = length.to_local()
    return 0 if length.is_meta else int(length)


def _lm_decode_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    b = cell.dims["global_batch"]
    kv = cell.dims["kv_len"]
    batch_div = b % _axis_size(mesh, dp(mesh)) == 0
    cfg, fields, pshape, pspec, *_ = _lm_param_trees(
        spec, mesh, batch_div=batch_div, seq_axis=None)
    # flash-decoding for MLA archs: the latent cache shards over the
    # sequence; shards combine via a log-sum-exp reduction
    flash = (cfg.mla is not None and batch_div
             and kv % axis_sizes(mesh)["model"] == 0)
    if flash:
        fields["mla"] = {**fields["mla"], "mesh": mesh,
                         "decode_flash": True, "dp_axis": dp(mesh),
                         "tp_axis": "model"}
        cfg = _with_fields(spec.config, fields)
    state_shape = init_decode_state(cfg, b, kv, device="meta")
    state_shape["length"] = meta((), torch.int32)
    dpa = dp(mesh)
    b_div = b % _axis_size(mesh, dpa) == 0

    def cache_spec(leaf):
        nd = leaf.dim()
        if nd >= 4:  # [L, B, S, ...] kv or latent cache
            if b_div:
                if flash and nd == 4:
                    # MLA flash-decoding: latent cache seq-sharded
                    return _sanitize(P(None, dpa, "model", None),
                                     leaf.shape, mesh)
                # GQA path: batch over data; the trailing head_dim over
                # model (sharding the sequence would put the per-token
                # cache update astride shard boundaries)
                return _sanitize(
                    P(*((None, dpa) + (None,) * (nd - 3) + ("model",))),
                    leaf.shape, mesh)
            seq_axes = (dpa, "model") if isinstance(dpa, str) \
                else tuple(dpa) + ("model",)
            return _sanitize(
                P(*((None, None, seq_axes) + (None,) * (nd - 3))),
                leaf.shape, mesh)
        return P(*([None] * nd))

    sspec = tree_map(cache_spec, state_shape)
    tokens = meta((b, 1), torch.int32)
    tspec = P(dpa, None) if b_div else P(None, None)

    @torch.no_grad()
    def serve_step(params, state, tokens):
        length = state["length"]
        with _spmd():
            logits, new = lm_decode_step(
                bind_lm(cfg, params), cfg, tokens,
                {"cache": state["cache"], "length": _host_length(length)})
        # the reference returns the per-layer lengths zeroed and the
        # step's length as a 0-d int32
        state["cache"][2].zero_()
        length.add_(new["length"] - _host_length(length))
        return logits, state

    return Cell(spec.arch_id, cell.name, serve_step,
                (pshape, state_shape, tokens), (pspec, sspec, tspec),
                (_sanitize(P(dpa, None, "model"),
                           (b, 1, cfg.vocab), mesh), sspec),
                donate=(1,),
                static={"mesh_fields": fields, "decode_flash": flash,
                        "cfg": cfg})


# ============================================== modules bound to a tree
def _bind(module: nn.Module, tree, stacked=()) -> nn.Module:
    """``module`` (built on ``"meta"``) with the tree's tensors as its
    parameters, sharing their storage: an in-place update of a parameter
    updates the tree (a stacked leaf's layers are views of it)."""
    flat = convert.flatten_params(tree, stacked)
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise KeyError(f"tree and module differ: "
                       f"{sorted(set(flat) ^ set(params))}")
    for name, t in flat.items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        old = sub._parameters[leaf]
        if t.shape != old.shape or t.dtype != old.dtype:
            raise ValueError(f"{name}: tree {tuple(t.shape)} {t.dtype}, "
                             f"module {tuple(old.shape)} {old.dtype}")
        sub._parameters[leaf] = nn.Parameter(t, requires_grad=True)
    return module


@contextlib.contextmanager
def _spmd():
    """Where a cell's ``fn`` runs on ``DTensor``s: plain tensors made
    inside (positions, masks, softmax state) count as replicated, and
    layouts are ranked by greedy plans (``sharding.greedy_layout_search``)."""
    with implicit_replication(), greedy_layout_search():
        yield


def _grad_like(p):
    """``p.grad`` in ``p``'s layout (a ``DTensor`` gradient may come back
    partial or otherwise placed: a layout change only)."""
    g = p.grad
    if isinstance(g, DTensor) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def _train_fn(make: Callable, loss_of: Callable, ocfg: AdamWConfig,
              stacked=()) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: the loss's backward and one AdamW step over the reference's
    flatten order, params and moments updated in place."""
    def train_step(params, opt_state, batch):
        with _spmd():
            model = _bind(make(), params, stacked)
            opt = {"m": convert.flatten_params(opt_state["m"], stacked),
                   "v": convert.flatten_params(opt_state["v"], stacked),
                   "step": opt_state["step"]}
            loss = loss_of(model, batch)
            loss.backward()
            named = convert.ref_order(model)
            adamw_update(named, {n: _grad_like(p) for n, p in named.items()},
                         opt, ocfg, decay=convert.decayed(model))
        return (params, {"m": opt_state["m"], "step": opt["step"],
                         "v": opt_state["v"]}, loss.detach())
    return train_step


def _module_trees(spec: ArchSpec, make: Callable, mesh, family: str):
    model = make()
    pshape = convert.gnn_tree(model)
    pspec = param_specs(pshape, mesh, family)
    ocfg = _opt_cfg(spec)
    oshape = convert.opt_tree(adamw_init(convert.ref_order(model), ocfg),
                              model)
    return pshape, pspec, oshape, opt_specs(oshape, pspec), ocfg


def _nll(logits, labels) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, labels[:, None].long()).mean()


# ===================================================================== GNN
def _gnn_param_trees(spec: ArchSpec, mesh, d_in, n_classes, **over):
    cfg = dataclasses.replace(spec.config, d_in=d_in, n_classes=n_classes,
                              **over)
    make = lambda: GNN(None, cfg, device="meta")    # noqa: E731
    return (cfg, make) + _module_trees(spec, make, mesh, "gnn")


def _gnn_full_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    d = cell.dims
    cfg, make, pshape, pspec, oshape, ospec, ocfg = _gnn_param_trees(
        spec, mesh, d["d_feat"], d["n_classes"])
    n, e2 = d["n_nodes"], 2 * d["n_edges"]
    dpa = dp(mesh)
    batch = {"x": meta((n, d["d_feat"]), torch.float32),
             "edge_index": meta((2, e2), torch.int32),
             "labels": meta((n,), torch.int32),
             "mask": meta((n,), torch.float32)}
    bspec = {"x": _sanitize(P(dpa, None), (n, d["d_feat"]), mesh),
             "edge_index": _sanitize(P(None, dpa), (2, e2), mesh),
             "labels": _sanitize(P(dpa), (n,), mesh),
             "mask": _sanitize(P(dpa), (n,), mesh)}
    loss_of = lambda m, b: gnn.gnn_loss(                 # noqa: E731
        m, cfg, b["x"], b["edge_index"], b["labels"], b["mask"])
    return Cell(spec.arch_id, cell.name, _train_fn(make, loss_of, ocfg),
                (pshape, oshape, batch), (pspec, ospec, bspec),
                (pspec, ospec, P()), donate=(0, 1))


def _gnn_sampled_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    d = cell.dims
    cfg, make, pshape, pspec, oshape, ospec, ocfg = _gnn_param_trees(
        spec, mesh, d["d_feat"], d["n_classes"], n_layers=2)  # 15-10 hops
    b, f0, f1 = d["batch_nodes"], d["fanout0"], d["fanout1"]
    n1, n2 = b * f0, b * f0 * f1
    dpa = dp(mesh)
    batch = {
        "feats": [meta((m, d["d_feat"]), torch.float32) for m in (b, n1, n2)],
        "nbr_idx": [meta((b, f0), torch.int32), meta((n1, f1), torch.int32)],
        "nbr_valid": [meta((b, f0), torch.bool), meta((n1, f1), torch.bool)],
        "labels": meta((b,), torch.int32),
    }
    bspec = {
        "feats": [_sanitize(P(dpa, None), (m, d["d_feat"]), mesh)
                  for m in (b, n1, n2)],
        "nbr_idx": [_sanitize(P(dpa, None), (b, f0), mesh),
                    _sanitize(P(dpa, None), (n1, f1), mesh)],
        "nbr_valid": [_sanitize(P(dpa, None), (b, f0), mesh),
                      _sanitize(P(dpa, None), (n1, f1), mesh)],
        "labels": _sanitize(P(dpa), (b,), mesh),
    }

    def loss_of(m, b):
        return _nll(gnn.gnn_forward_sampled(m, cfg, b["feats"], b["nbr_idx"],
                                            b["nbr_valid"]), b["labels"])

    return Cell(spec.arch_id, cell.name, _train_fn(make, loss_of, ocfg),
                (pshape, oshape, batch), (pspec, ospec, bspec),
                (pspec, ospec, P()), donate=(0, 1))


def _gnn_mol_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    d = cell.dims
    nb = d["batch"]
    n_tot = nb * d["n_nodes"]
    e_tot = nb * d["n_edges"] * 2
    cfg, make, pshape, pspec, oshape, ospec, ocfg = _gnn_param_trees(
        spec, mesh, d["n_species"], 2)
    dpa = dp(mesh)
    batch = {"x": meta((n_tot, d["n_species"]), torch.float32),
             "edge_index": meta((2, e_tot), torch.int32),
             "graph_id": meta((n_tot,), torch.int32),
             "labels": meta((nb,), torch.int32)}
    bspec = {"x": _sanitize(P(dpa, None), (n_tot, d["n_species"]), mesh),
             "edge_index": _sanitize(P(None, dpa), (2, e_tot), mesh),
             "graph_id": _sanitize(P(dpa), (n_tot,), mesh),
             "labels": _sanitize(P(dpa), (nb,), mesh)}

    def loss_of(m, b):
        return _nll(gnn.gnn_forward_batched(m, cfg, b["x"], b["edge_index"],
                                            b["graph_id"], nb), b["labels"])

    return Cell(spec.arch_id, cell.name, _train_fn(make, loss_of, ocfg),
                (pshape, oshape, batch), (pspec, ospec, bspec),
                (pspec, ospec, P()), donate=(0, 1))


# =================================================================== equiv
def _equiv_cells(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    d = cell.dims
    cfg = spec.config
    # edge-chunked message streaming for full-batch-large cells
    if d.get("n_edges", 0) > 4_000_000:
        cfg = dataclasses.replace(cfg, edge_chunk=1 << 20)
    make = lambda: Equiv(None, cfg, device="meta")      # noqa: E731
    pshape, pspec, oshape, ospec, ocfg = _module_trees(spec, make, mesh,
                                                       "equiv")
    dpa = dp(mesh)

    if cell.kind == "batched_graphs":
        nb = d["batch"]
        n_tot, e_tot = nb * d["n_nodes"], nb * d["n_edges"] * 2
        batch = {"species": meta((n_tot,), torch.int32),
                 "positions": meta((n_tot, 3), torch.float32),
                 "edge_index": meta((2, e_tot), torch.int32),
                 "graph_id": meta((n_tot,), torch.int32),
                 "energy": meta((nb,), torch.float32)}
        loss_of = lambda m, b: equiv_batched_loss(m, cfg, b, nb)  # noqa
    else:
        if cell.kind == "sampled":
            n = d["batch_nodes"] * (1 + d["fanout0"]
                                    + d["fanout0"] * d["fanout1"])
            e2 = 2 * d["batch_nodes"] * (d["fanout0"]
                                         + d["fanout0"] * d["fanout1"])
        else:
            n, e2 = d["n_nodes"], 2 * d["n_edges"]
        batch = {"species": meta((n,), torch.int32),
                 "positions": meta((n, 3), torch.float32),
                 "edge_index": meta((2, e2), torch.int32),
                 "energy": meta((), torch.float32)}
        loss_of = lambda m, b: equiv_energy_loss(m, cfg, b)  # noqa: E731

    bspec = tree_map(
        lambda s: _sanitize(
            P(*((dpa,) + (None,) * (s.dim() - 1)))
            if s.dim() >= 1 and s.shape[0] not in (2,)
            else P(*((None, dpa) + (None,) * (s.dim() - 2))),
            s.shape, mesh),
        batch)
    return Cell(spec.arch_id, cell.name, _train_fn(make, loss_of, ocfg),
                (pshape, oshape, batch), (pspec, ospec, bspec),
                (pspec, ospec, P()), donate=(0, 1))


# ================================================================== recsys
def _din_cells(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    cfg = spec.config
    make = lambda: DIN(None, cfg, device="meta")        # noqa: E731
    pshape, pspec, oshape, ospec, ocfg = _module_trees(spec, make, mesh,
                                                       "recsys")
    dpa = dp(mesh)
    L = cfg.seq_len

    def batch_of(b):
        return {"target_item": meta((b,), torch.int32),
                "target_cat": meta((b,), torch.int32),
                "hist_items": meta((b, L), torch.int32),
                "hist_cats": meta((b, L), torch.int32),
                "hist_mask": meta((b, L), torch.float32),
                "dense_feats": meta((b, cfg.n_dense_feats), torch.float32),
                "labels": meta((b,), torch.int32)}

    def spec_of(b):
        return tree_map(
            lambda s: _sanitize(P(*((dpa,) + (None,) * (s.dim() - 1))),
                                s.shape, mesh),
            batch_of(b))

    if cell.kind == "recsys_train":
        b = cell.dims["batch"]
        loss_of = lambda m, bt: recsys.din_loss(m, cfg, bt)  # noqa: E731
        return Cell(spec.arch_id, cell.name,
                    _train_fn(make, loss_of, ocfg),
                    (pshape, oshape, batch_of(b)), (pspec, ospec, spec_of(b)),
                    (pspec, ospec, P()), donate=(0, 1))

    if cell.kind == "recsys_serve":
        b = cell.dims["batch"]
        batch, bspec = batch_of(b), spec_of(b)
        batch.pop("labels")
        bspec.pop("labels")

        @torch.no_grad()
        def serve(params, batch):
            return recsys.din_forward(_bind(make(), params), cfg, batch)

        return Cell(spec.arch_id, cell.name, serve, (pshape, batch),
                    (pspec, bspec), _sanitize(P(dpa), (b,), mesh))

    # retrieval: 1 user x n_candidates
    n = cell.dims["n_candidates"]
    user = {"hist_items": meta((L,), torch.int32),
            "hist_cats": meta((L,), torch.int32),
            "hist_mask": meta((L,), torch.float32),
            "dense_feats": meta((cfg.n_dense_feats,), torch.float32)}
    uspec = tree_map(lambda s: P(*([None] * s.dim())), user)
    cands = (meta((n,), torch.int32), meta((n,), torch.int32))
    cspec = (_sanitize(P(dpa), (n,), mesh), _sanitize(P(dpa), (n,), mesh))

    @torch.no_grad()
    def retrieve(params, user, cand_items, cand_cats):
        return recsys.din_score_candidates(_bind(make(), params), cfg, user,
                                           cand_items, cand_cats)

    return Cell(spec.arch_id, cell.name, retrieve,
                (pshape, user) + cands, (pspec, uspec) + cspec,
                _sanitize(P(dpa), (n,), mesh))


# ================================================================= matcher
def _hier_graph_structs(v: int, w: int, d: dict):
    """Shapes and specs of the hierarchical adjacency layout, gated on
    the cell's ``hier_adjacency`` dims flag. The summary shards its
    vertex axis over the model axis as the dense block does;
    ``chunk_ptr`` and the chunk store are indexed by global offsets, so
    they replicate. The reference's shape-only ``chunk_pad`` lane is the
    port's static ``kmax``."""
    from ..core.engine_step import GraphArrays
    cw = int(d.get("chunk_words", 8))
    n_chunks = (w + cw - 1) // cw
    swn = (n_chunks + 31) // 32
    kmax = int(d.get("kmax", min(64, max(1, n_chunks))))
    n_stored = int(d.get("n_stored", v * min(4, max(1, n_chunks)))) + kmax
    g = GraphArrays(
        adj_bitmap=None, n_vertices=meta((), torch.int32),
        adj_summary=meta((v, swn), torch.int32),
        chunk_ptr=meta((v + 1,), torch.int32),
        chunk_id=meta((n_stored,), torch.int32),
        chunk_data=meta((n_stored, cw), torch.int32), kmax=kmax)
    gspec = GraphArrays(
        adj_bitmap=None, n_vertices=P(),
        adj_summary=P("model", None), chunk_ptr=P(None),
        chunk_id=P(None), chunk_data=P(None, None), kmax=kmax)
    return g, gspec


def _matcher_banks(d: dict, mesh):
    from ..core.engine_step import N_PAD, GraphArrays, QueryBank
    from ..patterns.store import MASK_WORDS, PatternStoreBank
    v = d["n_vertices"]
    w = (v + 31) // 32
    s = d.get("n_slots", 16)
    cap = d.get("pattern_capacity", 65_536)
    i32 = torch.int32
    if d.get("hier_adjacency"):
        g, gspec = _hier_graph_structs(v, w, d)
    else:
        g = GraphArrays(adj_bitmap=meta((v, w), i32),
                        n_vertices=meta((), i32))
        gspec = GraphArrays(adj_bitmap=P("model", None), n_vertices=P())
    qb = QueryBank(cand_bitmap=meta((s, N_PAD, w), i32),
                   nbr_mask=meta((s, N_PAD, N_PAD), torch.bool),
                   n_query=meta((s,), i32),
                   learn=meta((s,), torch.bool))
    tb = PatternStoreBank(key_pos=meta((s, cap), i32),
                          key_v=meta((s, cap), i32),
                          phi=meta((s, cap), i32), mu=meta((s, cap), i32),
                          mask=meta((s, cap, MASK_WORDS), i32),
                          valid=meta((s, cap), torch.bool),
                          hits=meta((s, cap), i32))
    # banks replicate the (small) slot axis; the hashed Δ store is
    # O(capacity), data-graph independent, so it replicates too
    qbspec = QueryBank(cand_bitmap=P(None, None, None),
                       nbr_mask=P(None, None, None),
                       n_query=P(None), learn=P(None))
    tbspec = PatternStoreBank(*(P(*([None] * t.dim())) for t in tb))
    return (g, qb, tb), (gspec, qbspec, tbspec), v, w, s


def _replicated(cls):
    """A NamedTuple of ``cls`` with every field replicated (``P()``)."""
    return cls(*([P()] * len(cls._fields)))


def _matcher_on_mesh(body: Callable, gspec, out_specs) -> Callable:
    """A matcher cell's ``fn``: ``body(g, *rest)`` as it is on plain
    tensors; on ``DTensor``s, ``body`` on each rank's local tensors. The
    graph's row-split table (``adj_bitmap``, or ``adj_summary`` with the
    hier layout) is placed by ``gspec`` and taken as this rank's rows
    (``GraphArrays.split`` says which); every other argument is gathered
    whole (the per-row lanes over the data axes, in row order), so every
    rank runs the same single-device step. The outputs are placed by
    ``out_specs`` (per-row lanes: this rank's rows of the whole result);
    a donated bank, updated in place, is returned as the ``DTensor``
    that came in."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from ..core.engine_step import RowSplit
    from ..models.layers import constrain, constrain_to

    def fn(g, *rest):
        dts = [t for _, t in tree_leaves_with_path((g, rest))
               if isinstance(t, DTensor)]
        if not dts:
            return body(g, *rest)
        mesh = dts[0].device_mesh
        kept: dict = {}

        def whole(t):
            if not isinstance(t, DTensor):
                return t
            local = constrain_to(t, [Replicate()] * mesh.ndim).to_local()
            kept[id(local)] = (local, t)
            return local

        name = "adj_bitmap" if g.chunk_data is None else "adj_summary"
        spec = getattr(gspec, name)            # P("model", None)
        table = constrain_to(getattr(g, name), placements(spec, mesh))
        _, offset = compute_local_shape_and_global_offset(
            table.shape, mesh, table.placements)
        local_g = tree_map(whole, g._replace(**{name: None}))._replace(**{
            name: table.to_local(),
            "split": RowSplit(mesh, spec[0], int(offset[0]),
                              int(table.shape[0]), dp_axes(mesh))})
        out = body(local_g, *tree_map(whole, rest))
        specs = dict(tree_leaves_with_path(out_specs))

        def place(path, t):
            if id(t) in kept and kept[id(t)][0] is t:
                return kept[id(t)][1]
            dt = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
            return constrain(dt, specs[path])
        return tree_map_with_path(place, out)
    return fn


def _matcher_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    """The multi-query wave program (``expand_wave_mq``) that the
    shared-wave scheduler dispatches: slot-stacked query banks and
    hashed Δ store plus per-row slot / depth lanes."""
    from ..core.engine_step import N_PAD, WaveResultMQ, expand_wave_mq
    from ..patterns.store import MASK_WORDS, PatternStoreBank
    d = cell.dims
    (g, qb, tb), (gspec, qbspec, tbspec), v, w, s = _matcher_banks(d, mesh)
    f = d["wave_size"]
    kpr = d["kpr"]
    dpa = dp(mesh)
    i32 = torch.int32
    frontier = meta((f, N_PAD), i32)
    used = meta((f, w), i32)
    phi = meta((f, N_PAD + 1), i32)
    row_valid = meta((f,), torch.bool)
    query_slot = meta((f,), i32)
    depth = meta((f,), i32)
    fspec = (_sanitize(P(dpa, None), (f, N_PAD), mesh),
             _sanitize(P(dpa, None), (f, w), mesh),
             _sanitize(P(dpa, None), (f, N_PAD + 1), mesh),
             _sanitize(P(dpa), (f,), mesh),
             _sanitize(P(dpa), (f,), mesh),
             _sanitize(P(dpa), (f,), mesh))

    def body(g, qb, tb, frontier, used, phi, row_valid, query_slot,
             depth):
        return expand_wave_mq(g, qb, tb, frontier, used, phi, row_valid,
                              query_slot, depth, kpr=kpr), tb

    # per-row result lanes follow the frontier's data sharding; the
    # returned store stays replicated like its input
    res_spec = _replicated(WaveResultMQ)._replace(
        child_v=_sanitize(P(dpa, None), (f, kpr), mesh),
        child_valid=_sanitize(P(dpa, None), (f, kpr), mesh),
        pruned_v=_sanitize(P(dpa, None), (f, kpr), mesh),
        leftover=_sanitize(P(dpa, None), (f, w), mesh),
        partial_mask=_sanitize(P(dpa, None), (f, MASK_WORDS), mesh),
        refined_empty=_sanitize(P(dpa), (f,), mesh),
        n_children=_sanitize(P(dpa), (f,), mesh),
        n_leftover=_sanitize(P(dpa), (f,), mesh),
        n_pruned=_sanitize(P(dpa), (f,), mesh),
        n_inj=_sanitize(P(dpa), (f,), mesh))
    out_spec = (res_spec, _replicated(PatternStoreBank))
    return Cell(spec.arch_id, cell.name,
                _matcher_on_mesh(body, gspec, out_spec),
                (g, qb, tb, frontier, used, phi, row_valid, query_slot,
                 depth),
                (gspec, qbspec, tbspec) + fspec, out_spec)


def _matcher_stack_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    """The device-resident scheduling step (``run_device_megastep``):
    per-slot frontier stacks, on-device wave repacking and Lemma-4
    resolution; only root lanes come in, only per-slot scalars and
    embedding rows go back."""
    from ..core.engine_step import (N_PAD, DeviceResult, StackBank,
                                    run_device_megastep)
    from ..patterns.store import MASK_WORDS, PatternStoreBank
    d = cell.dims
    (g, qb, tb), (gspec, qbspec, tbspec), v, w, s = _matcher_banks(d, mesh)
    f = d["wave_size"]
    kpr = d["kpr"]
    depth_cap = d["stack_capacity"]
    t_max = d.get("megastep_depth", 6)
    emb_cap = d.get("emb_cap", max(512, f * kpr))
    dpa = dp(mesh)
    i32 = torch.int32
    sd = (s, depth_cap)
    sb = StackBank(frontier=meta(sd + (N_PAD,), i32),
                   used=meta(sd + (w,), i32),
                   phi=meta(sd + (N_PAD + 1,), i32),
                   depth=meta(sd, i32), cand=meta(sd + (w,), i32),
                   state=meta(sd, torch.int8),
                   gamma=meta(sd + (MASK_WORDS,), i32),
                   outstanding=meta(sd, i32),
                   reported=meta(sd, torch.bool), parent=meta(sd, i32),
                   pstack=meta(sd, i32), ptop=meta((s,), i32))
    in_root = meta((f,), i32)
    in_rid = meta((f,), i32)
    in_slot = meta((f,), i32)
    in_valid = meta((f,), torch.bool)
    active = meta((s,), torch.bool)

    # the stack is per-slot scheduler state, O(n_slots * depth_cap) and
    # data-graph independent, so like the banks it replicates; only the
    # root lanes are data-sharded
    sbspec = tree_map(lambda x: P(*([None] * x.dim())), sb)
    rspec = _sanitize(P(dpa), (f,), mesh)

    def body(g, qb, tb, sb, in_root, in_rid, in_slot, in_valid, active):
        return run_device_megastep(
            g, qb, tb, sb, in_root, in_rid, in_slot, in_valid, active,
            1, True, t_max, kpr=kpr, emb_cap=emb_cap)

    out_spec = _replicated(DeviceResult)._replace(
        tb=_replicated(PatternStoreBank), sb=_replicated(StackBank))
    return Cell(spec.arch_id, cell.name,
                _matcher_on_mesh(body, gspec, out_spec),
                (g, qb, tb, sb, in_root, in_rid, in_slot, in_valid,
                 active),
                (gspec, qbspec, tbspec, sbspec, rspec, rspec, rspec,
                 rspec, P(None)),
                out_spec)


def matcher_args(dims: dict, data, queries, device="cuda") -> tuple:
    """Real arguments for a matcher cell of ``dims``: ``data`` (a
    ``Graph`` of ``dims["n_vertices"]`` vertices) in ``GraphArrays``,
    the dense block, or with ``hier_adjacency`` the two-level layout of
    ``dims.get("chunk_words", 8)``-word chunks from the scheduler's
    builder (``Graph.hier_bitmap``; its ``kmax`` the static field), up
    to ``n_slots`` ``queries`` installed one a slot
    by ``load_slots`` into empty banks, and one row for each root
    candidate of theirs taken round robin over the slots, up to the wave
    size: root lanes for the stack cell, depth-1 frontier rows (root
    bit in ``used``, row id in ``phi[:, 1]``) for the wave cell."""
    from ..core.backtrack import _prepare
    from ..core.engine_step import (N_PAD, GraphArrays, QueryBank,
                                    StackBank, load_slots)
    from ..core.graph import pack_bitmap
    from ..kernels.config import resolve_device
    from ..patterns.store import PatternStore, PatternStoreBank
    dev = resolve_device(device)
    v = dims["n_vertices"]
    if data.n != v:
        raise ValueError(f"a graph of {v} vertices is needed, got "
                         f"{data.n}")
    w = (v + 31) // 32
    s = dims.get("n_slots", 16)
    cap = dims.get("pattern_capacity", 65_536)
    f = dims["wave_size"]
    queries = list(queries)[:s]
    k = len(queries)

    def i32(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a).to(dev)

    n_vertices = torch.tensor(v, dtype=torch.int32, device=dev)
    if dims.get("hier_adjacency"):
        hb = data.hier_bitmap(chunk_words=int(dims.get("chunk_words", 8)))
        g = GraphArrays(adj_bitmap=None, n_vertices=n_vertices,
                        adj_summary=i32(hb.summary),
                        chunk_ptr=i32(hb.chunk_ptr),
                        chunk_id=i32(hb.chunk_id),
                        chunk_data=i32(hb.chunk_data), kmax=hb.kmax)
    else:
        g = GraphArrays(adj_bitmap=i32(data.adj_bitmap),
                        n_vertices=n_vertices)
    qb = QueryBank.empty(s, w, dev)
    tb = PatternStoreBank.empty(s, cap, dev)
    cands, nbrs, roots = [], [], []
    for q in queries:
        cand_by_pos, _order, _pos_of, nbr_pos = _prepare(q, data, None,
                                                         None)
        dense = np.zeros((N_PAD, v), bool)
        nm = np.zeros((N_PAD, N_PAD), bool)
        for dd in range(q.n):
            dense[dd, cand_by_pos[dd]] = True
            nm[dd, np.asarray(nbr_pos[dd], np.int64)] = True
        cands.append(pack_bitmap(dense))
        nbrs.append(nm)
        roots.append(np.asarray(cand_by_pos[0], np.int32))
    empty = PatternStore.empty(cap, dev)
    load_slots(qb, tb, torch.arange(k, device=dev), i32(np.stack(cands)),
               i32(np.stack(nbrs)),
               torch.tensor([q.n for q in queries], dtype=torch.int32,
                            device=dev),
               PatternStore(*(lane.expand(k, *lane.shape).clone()
                              for lane in empty)),
               torch.ones(k, dtype=torch.bool, device=dev))
    # round robin over the slots' root candidates, up to the wave size
    order = sorted(((j, slot) for slot in range(k)
                    for j in range(len(roots[slot]))))[:f]
    slot_of = np.array([sl for _, sl in order], np.int32)
    root_of = np.array([roots[sl][j] for j, sl in order], np.int32)
    n = len(order)
    rid = np.arange(1, n + 1, dtype=np.int32)
    lane = np.zeros(f, np.int32)
    valid = np.zeros(f, bool)
    valid[:n] = True

    def padded(a):
        out = lane.copy()
        out[:n] = a
        return i32(out)

    if "stack_capacity" in dims:
        sb = StackBank.empty(s, dims["stack_capacity"], w, dev)
        active = np.zeros(s, bool)
        active[:k] = True
        return (g, qb, tb, sb, padded(root_of), padded(rid),
                padded(slot_of), i32(valid), i32(active))
    frontier = np.full((f, N_PAD), -1, np.int32)
    frontier[:n, 0] = root_of
    used = np.zeros((f, w), np.uint32)
    used[np.arange(n), root_of // 32] = (
        np.uint32(1) << (root_of.astype(np.uint32) % np.uint32(32)))
    phi = np.zeros((f, N_PAD + 1), np.int32)
    phi[:n, 1] = rid
    depth = np.where(valid, 1, 0).astype(np.int32)
    return (g, qb, tb, i32(frontier), i32(used), i32(phi), i32(valid),
            padded(slot_of), i32(depth))


# ================================================== inputs of model cells
def example_args(spec: ArchSpec, shape: ShapeCell, cell: Cell, seed: int = 0,
                 device="cuda") -> tuple:
    """Random valid arguments of a GNN, equivariant or DIN cell, drawn
    on ``device`` by a ``torch.Generator`` seeded ``seed``: parameters
    ~ N(0, 0.1^2) (0.01^2 for leaves of fewer than two dimensions), a
    train step's moments nonzero (``v`` positive) at step 5, indices in
    range (edges within each molecule, no self-loops in a potential's
    edge list, so no pair sits at distance 0)."""
    from ..kernels.config import resolve_device
    if spec.family == "lm":
        return _lm_example_args(shape, cell, seed, device)
    if spec.family not in ("gnn", "equiv", "recsys"):
        raise ValueError(f"no example inputs for the {spec.family} family")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, cfg = shape.dims, spec.config

    def normal(t, std=1.0):
        return torch.randn(t.shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(std).to(t.dtype)

    def ints(t, lo, hi):
        return torch.randint(lo, hi, t.shape, generator=gen, device=dev,
                             dtype=torch.int64).to(t.dtype)

    def coin(t, p):
        return torch.rand(t.shape, generator=gen, device=dev) < p

    def param(t):
        return normal(t, 0.1 if t.dim() >= 2 else 0.01)

    def molecules(nb, per, edges):
        src = torch.randint(0, per, (nb, edges), generator=gen, device=dev)
        hop = torch.randint(1, per, (nb, edges), generator=gen, device=dev)
        base = (torch.arange(nb, device=dev) * per)[:, None]
        e = torch.stack([src + base, (src + hop) % per + base])
        e = torch.cat([e, e.flip(0)], dim=1).reshape(2, -1)
        gid = torch.arange(nb * per, device=dev) // per
        return e.to(torch.int32), gid.to(torch.int32)

    def edges_between(n, e2):
        src = torch.randint(0, n, (e2,), generator=gen, device=dev)
        hop = torch.randint(1, n, (e2,), generator=gen, device=dev)
        return torch.stack([src, (src + hop) % n]).to(torch.int32)

    args = list(cell.args)
    args[0] = tree_map(param, args[0])
    batch = args[-1] if len(args) == 3 else args[1]
    if len(args) == 3 and cell.donate:            # a train step
        opt = args[1]
        args[1] = {"m": tree_map(lambda t: normal(t, 1e-3), opt["m"]),
                   "v": tree_map(lambda t: torch.rand(
                       t.shape, generator=gen, device=dev).mul_(1e-4)
                       .add_(1e-6).to(t.dtype), opt["v"]),
                   "step": torch.tensor(5, dtype=torch.int32, device=dev)}
    if spec.family == "gnn":
        out = tree_map(normal, batch)
        if shape.kind == "sampled":
            b, f0 = d["batch_nodes"], d["fanout0"]
            out["nbr_idx"] = [ints(batch["nbr_idx"][0], 0, b * f0),
                              ints(batch["nbr_idx"][1], 0,
                                   b * f0 * d["fanout1"])]
            out["nbr_valid"] = [coin(t, 0.8) for t in batch["nbr_valid"]]
        elif shape.kind == "batched_graphs":
            out["edge_index"], out["graph_id"] = molecules(
                d["batch"], d["n_nodes"], d["n_edges"])
        else:
            out["edge_index"] = ints(batch["edge_index"], 0, d["n_nodes"])
            out["mask"] = coin(batch["mask"], 0.5).float()
        n_classes = 2 if shape.kind == "batched_graphs" else d["n_classes"]
        out["labels"] = ints(batch["labels"], 0, n_classes)
    elif spec.family == "equiv":
        out = tree_map(normal, batch)
        n = batch["species"].shape[0]
        out["positions"] = torch.rand(
            (n, 3), generator=gen, device=dev).mul_(2.0 * cfg.cutoff)
        if shape.kind == "batched_graphs":
            out["edge_index"], out["graph_id"] = molecules(
                d["batch"], d["n_nodes"], d["n_edges"])
            out["species"] = ints(batch["species"], 0,
                                  min(d["n_species"], cfg.n_species))
        else:
            out["edge_index"] = edges_between(n, batch["edge_index"]
                                              .shape[1])
            out["species"] = ints(batch["species"], 0, cfg.n_species)
    else:
        out = tree_map(normal, batch)
        items = {"target_item": cfg.n_items, "hist_items": cfg.n_items,
                 "target_cat": cfg.n_cats, "hist_cats": cfg.n_cats,
                 "labels": 2}
        for k, hi in items.items():
            if k in batch:
                out[k] = ints(batch[k], 0, hi)
        if "hist_mask" in batch:
            out["hist_mask"] = coin(batch["hist_mask"], 0.7).float()
        if shape.kind == "recsys_retrieval":
            args[2] = ints(args[2], 0, cfg.n_items)
            args[3] = ints(args[3], 0, cfg.n_cats)
    if len(args) == 3:
        args[2] = out
    else:
        args[1] = out
    return tuple(args)


_ONES = ("ln_attn", "ln_ffn", "ln_final", "q_norm", "k_norm", "kv_norm",
         "ln")


def _lm_example_args(shape: ShapeCell, cell: Cell, seed: int,
                     device) -> tuple:
    """Valid arguments of an LM cell drawn on ``device`` by a generator
    seeded ``seed``, leaf by leaf as ``lm_init`` draws them (matrices
    N(0, d_in^-1), the embedding N(0, 0.02^2), norms 1, biases 0); token
    ids in range; a train step's moments nonzero (``v`` positive) at
    step 5; a decode state's caches N(0, 1) with ``length`` past half the
    cache, so the step writes into it and the mask cuts it."""
    from ..kernels.config import resolve_device
    from ..models.layers import normal
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = cell.static["cfg"]

    def param(path, t):
        name = str(path[-1])
        if name in _ONES:
            return torch.ones(t.shape, dtype=t.dtype, device=dev)
        if name in ("b", "router_bias"):
            return torch.zeros(t.shape, dtype=t.dtype, device=dev)
        std = 0.02 if name == "embed" else t.shape[-2] ** -0.5
        return normal(gen, t.shape, std, t.dtype, dev)

    def tokens(t):
        return torch.randint(0, cfg.vocab, t.shape, generator=gen,
                             device=dev, dtype=torch.int64).to(t.dtype)

    args = list(cell.args)
    args[0] = tree_map_with_path(param, args[0])
    if shape.kind == "train":
        opt = args[1]
        args[1] = {"m": tree_map(lambda t: normal(gen, t.shape, 1e-3,
                                                  t.dtype, dev), opt["m"]),
                   "v": tree_map(lambda t: torch.rand(
                       t.shape, generator=gen, device=dev).mul_(1e-4)
                       .add_(1e-6).to(t.dtype), opt["v"]),
                   "step": torch.tensor(5, dtype=torch.int32, device=dev)}
        args[2] = tree_map(tokens, args[2])
    elif shape.kind == "prefill":
        args[1] = tokens(args[1])
    else:
        c0, c1, lens = args[1]["cache"]
        kv = c0.shape[2]
        args[1] = {"cache": (normal(gen, c0.shape, 1.0, c0.dtype, dev),
                             normal(gen, c1.shape, 1.0, c1.dtype, dev),
                             torch.zeros(lens.shape, dtype=lens.dtype,
                                         device=dev)),
                   "length": torch.tensor(kv // 2 + 1, dtype=torch.int32,
                                          device=dev)}
        args[2] = tokens(args[2])
    return tuple(args)


# ================================================================ dispatch
def build_cell(arch_id: str, shape_name: str, mesh) -> Cell:
    spec = get_arch(arch_id)
    return build_cell_of(spec, spec.shape(shape_name), mesh)


def build_cell_of(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    """``build_cell`` for any spec and shape cell (a reduced config or a
    small shape for tests)."""
    if spec.family == "lm":
        if cell.kind == "train":
            return _lm_train_cell(spec, cell, mesh)
        if cell.kind == "prefill":
            return _lm_prefill_cell(spec, cell, mesh)
        return _lm_decode_cell(spec, cell, mesh)
    if spec.family == "gnn":
        if cell.kind == "full_graph":
            return _gnn_full_cell(spec, cell, mesh)
        if cell.kind == "sampled":
            return _gnn_sampled_cell(spec, cell, mesh)
        return _gnn_mol_cell(spec, cell, mesh)
    if spec.family == "equiv":
        return _equiv_cells(spec, cell, mesh)
    if spec.family == "recsys":
        return _din_cells(spec, cell, mesh)
    if spec.family == "matcher":
        if "stack_capacity" in cell.dims:
            return _matcher_stack_cell(spec, cell, mesh)
        return _matcher_cell(spec, cell, mesh)
    raise ValueError(spec.family)
