"""Partition rules: parameter and input sharding per family (twin of
``repro.launch.sharding``).

Scheme: Megatron-style tensor parallel over the mesh ``model`` axis +
ZeRO-3-ish FSDP weight sharding over ``data``; batch over (pod, data).
Experts shard over ``model`` (EP); long-context KV caches shard the
sequence. Every rule passes through :func:`_sanitize`, which drops
assignments that do not divide the dimension, so one rule set serves
all ten architectures.

A rule is written as the reference writes it, a :class:`P` (the twin of
``jax.sharding.PartitionSpec``: one entry per tensor dimension, each
``None``, a mesh axis name or a tuple of names), so that spec trees
compare entry by entry with the reference's. :func:`placements` turns
one into DTensor placements (one ``Shard(d)`` or ``Replicate()`` per
mesh dimension); a dimension sharded over several mesh axes splits
major to minor in the mesh's axis order, as JAX does.

Trees are nested dicts, lists, tuples and ``NamedTuple``s whose leaves
are tensors (or :class:`P` specs); ``None`` and Python scalars pass
through :func:`tree_map` untouched.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Callable

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from .mesh import axis_sizes


class P(tuple):
    """A partition spec: ``P("data", None)`` shards dimension 0 over the
    ``data`` axis and replicates dimension 1."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# ------------------------------------------------------------------ trees
def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, P))


def _children(tree) -> list | None:
    """``(key, child)`` pairs of a dict, ``NamedTuple``, list or tuple;
    None for anything else."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, keeping the
    structure; a path is the tuple of dict keys, list indices and
    ``NamedTuple`` field names down to the leaf."""
    if _is_leaf(tree):
        return fn(path, tree)
    kids = _children(tree)
    if kids is None:
        return tree
    out = [tree_map_with_path(fn, v, path + (k,)) for k, v in kids]
    if isinstance(tree, dict):
        return dict(zip(tree, out))
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def tree_map(fn: Callable, tree):
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def tree_leaves_with_path(tree, path: tuple = ()) -> list:
    """``[(path, leaf)]`` in the tree's order."""
    if _is_leaf(tree):
        return [(path, tree)]
    return [pair for k, v in _children(tree) or ()
            for pair in tree_leaves_with_path(v, path + (k,))]


# ------------------------------------------------------------------ rules
def dp(mesh) -> Any:
    axes = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return axes if len(axes) > 1 else axes[0]


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _sanitize(spec: P, shape, mesh) -> P:
    """Drop axis assignments that don't divide the dimension."""
    out = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            out.append(None if i >= len(shape) else ax)
            continue
        out.append(ax if shape[i] % _axis_size(mesh, ax) == 0 else None)
    return P(*out[:len(shape)])


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


# (regex, spec builder taking ndim) — first match wins. ``L`` means the
# leading stacked-layer axis; rules are written for the stacked form and
# un-stacked leaves (mtp block) are handled by ndim.
def _lm_rules(fsdp, tp):
    def mat(*axes):
        return lambda nd: P(*((None,) * (nd - len(axes)) + axes))
    return [
        # vocab-sharded only: the vocab-parallel lookup owns it
        (r"embed$", lambda nd: P(tp, None)),
        (r"lm_head/w$", mat(fsdp, tp)),
        (r"(wq|wk|wv|wg|wu|wi)/w$", mat(fsdp, tp)),
        (r"(wo|wd)/w$", mat(tp, fsdp)),
        (r"(wq|wk|wv|wg|wu|wi)/b$", mat(tp)),
        (r"experts/(wg|wu)/w$",
         lambda nd: P(*((None,) * (nd - 3) + (tp, fsdp, None)))),
        (r"experts/wd/w$",
         lambda nd: P(*((None,) * (nd - 3) + (tp, None, fsdp)))),
        (r"router/w$", mat()),
        (r"(w_uq|w_uk|w_uv)/w$", mat(None, tp)),
        (r"(w_dq|w_dkv|w_kr)/w$", mat(fsdp, None)),
        (r"w_o/w$", mat(tp, fsdp)),
        (r"mtp/proj/w$", mat(fsdp, None)),
    ]


def param_specs(params_shape, mesh, family: str):
    """Parameter tree (tensors, ``meta`` or not) -> spec tree."""
    fsdp = "data"
    tp = "model"
    if family in ("lm",):
        rules = _lm_rules(fsdp, tp)
    elif family == "recsys":
        all_axes = tuple(mesh.mesh_dim_names)
        rules = [(r"(item_table|cat_table)$",
                  lambda nd: P(all_axes, None))]
    else:   # gnn / equiv / matcher: tiny params -> replicate
        rules = []

    def rule(path, leaf):
        ps = _path_str(path)
        nd = leaf.dim()
        for pat, builder in rules:
            if re.search(pat, ps):
                return _sanitize(builder(nd), leaf.shape, mesh)
        return P(*([None] * nd))

    return tree_map_with_path(rule, params_shape)


def opt_specs(opt_shape, pspecs):
    """Optimizer state shards exactly like its parameters."""
    return {"m": pspecs, "v": pspecs,
            "step": P()}


# ------------------------------------------------------------- placements
def placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh
    dimension, ``Shard(d)`` if tensor dimension ``d`` is split over it,
    else ``Replicate()``. Several axes on one dimension must follow the
    mesh's axis order (major to minor, as JAX splits a tuple entry)."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec!r}: axes {axes} are not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec!r}: axis {names[i]!r} used twice")
            out[i] = Shard(d)
    return out


def spec_of(t: DTensor) -> P:
    """The spec of a ``DTensor``'s placements (``placements``' inverse):
    for each dimension the mesh axes splitting it, in mesh order."""
    names = t.device_mesh.mesh_dim_names
    axes: list = [[] for _ in range(t.dim())]
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard):
            axes[pl.dim].append(names[i])
    return P(*(None if not a else a[0] if len(a) == 1 else tuple(a)
               for a in axes))


def shard(t: torch.Tensor, spec: P, mesh):
    """``t`` distributed over ``mesh`` by ``spec`` (a ``DTensor``; on a
    ``meta`` tensor, ``.to_local().shape`` is this rank's shard shape).
    On a one-rank mesh the shard is ``t`` itself, not a copy."""
    if mesh.size() == 1:
        return DTensor.from_local(t, mesh, placements(spec, mesh),
                                  run_check=False)
    return distribute_tensor(t, mesh, placements(spec, mesh))


def distribute(tree, specs, mesh):
    """Every tensor leaf of ``tree`` as a ``DTensor`` placed on ``mesh``
    by its spec in ``specs`` (a tree of the same structure); other leaves
    pass through. On several ranks every rank passes the same values
    (``distribute_tensor`` takes rank 0's)."""
    if torch.is_tensor(tree):
        return shard(tree, specs, mesh)
    kids = _children(tree)
    if kids is None:
        return tree
    spec_kids = dict(_children(specs))
    out = [distribute(v, spec_kids[k], mesh) for k, v in kids]
    if isinstance(tree, dict):
        return dict(zip(tree, out))
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def full(tree):
    """``tree`` with every ``DTensor`` leaf gathered whole
    (``full_tensor``) on every rank; on a one-rank mesh a leaf's local
    tensor is the whole, and is returned without a copy."""
    def whole(t):
        if not isinstance(t, DTensor):
            return t
        if t.device_mesh.size() == 1:
            return t.to_local()
        return t.full_tensor()
    return tree_map(whole, tree)


# ----------------------------------------------------------- DTensor cost
def _greedy_redistribute_cost(src, dst) -> float:
    """DTensor's ``redistribute_cost`` with every path planned greedily
    (its default for layouts in mesh order); a path the greedy planner
    cannot plan costs infinity."""
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._redistribute import get_redistribute_planner
    from torch.distributed.tensor.placement_types import _StridedShard
    default = all(DTensorSpec.is_default_device_order(o)
                  for o in (src.shard_order, dst.shard_order))
    strided = any(isinstance(p, _StridedShard)
                  for p in (*src.placements, *dst.placements))
    if default and not strided:
        return cu.redistribute_cost(src, dst)
    if src.placements == dst.placements:
        return 0.0
    try:
        infos = get_redistribute_planner(
            src.mesh, src.tensor_meta).generate_greedy_transform_infos(src,
                                                                        dst)
    except (AssertionError, NotImplementedError, ValueError, KeyError):
        return math.inf
    topo = cu.MeshTopoInfo.build_from_mesh(src.mesh)
    gb = cu.spec_to_bytes(src) / src.num_shards / 1024 ** 3
    cost = 0.0
    for info in infos:
        step, gb = cu._compute_placement_transition_cost(
            *info.src_dst_placements, topo, info.mesh_dim, gb)
        cost += step
    return cost


@contextlib.contextmanager
def greedy_layout_search():
    """Run DTensor ops with candidate layouts ranked by greedy plans.

    DTensor picks each op's layout by the cost of redistributing its
    inputs into every candidate. A candidate with a dimension split over
    two mesh axes (a batch over ``("pod", "data")``) is costed by a graph
    search whose state space grows with the mesh's rank: minutes for one
    small model on a three-axis mesh. Inside this context such candidates
    are costed by DTensor's greedy planner, as every other candidate is.
    Only the ranking changes; the redistributions that run are planned by
    DTensor as always, so values do not depend on it."""
    from torch.distributed.tensor._ops import utils
    old = utils.redistribute_cost
    utils.redistribute_cost = _greedy_redistribute_cost
    try:
        yield
    finally:
        utils.redistribute_cost = old
