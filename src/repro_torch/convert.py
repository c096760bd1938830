"""Carry state written by the JAX reference over to the port.

The reference's banks and entries are handed over as numpy arrays (or
any object whose fields are array-likes of the same names — the
reference's ``NamedTuple`` banks qualify once read with ``np.asarray``),
so this module needs neither JAX nor the ``repro`` package. uint32
words become int32 tensors with the same bit patterns; every other lane
keeps its type.

    from repro_torch import convert
    tb = convert.store_bank(jax_tb)              # on the card
    g = convert.graph_arrays(jax_sched.g, device="cpu")
    entries = convert.entries(jax_entries)       # -> seed_patterns

The model zoo's parameters come over the same way: the reference's
parameter pytree, read with ``jax.tree_util.tree_map(np.asarray, params)``
(bfloat16 leaves included), becomes the port's module with the same
weights:

    lm = convert.lm_params(tree, cfg, device="cpu")   # an LM module

and back: ``lm_tree`` / ``gnn_tree`` give a port module's parameters as
the reference's tree (tensors; LM layers stacked again on axis 0),
``opt_tree`` the optimizer state as the reference's ``{"m", "step",
"v"}`` tree and ``opt_state`` the reverse; ``ref_order`` lists a
module's parameters in the order the reference flattens its tree, and
``decayed`` names those whose reference leaf has two or more dimensions
(the leaves the reference's AdamW decays). These
trees are what ``training.checkpoint`` writes in the reference's layout.

Like every entry point of the port, these place tensors on ``"cuda"``
unless the caller asks for another device, and raise without a card.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.engine_step import GraphArrays, QueryBank, StackBank
from .kernels.config import resolve_device
from .patterns.store import ENTRY_KEYS, PatternStoreBank

__all__ = ["as_int32", "to_tensor", "graph_arrays", "query_bank",
           "store_bank", "stack_bank", "entries", "to_numpy",
           "flatten_params", "load_params", "lm_params", "gnn_params",
           "equiv_params", "din_params", "lm_tree", "gnn_tree", "opt_tree",
           "opt_state", "ref_order", "decayed"]


def as_int32(a) -> np.ndarray:
    """numpy view of an array with uint32 words reinterpreted as int32
    (other dtypes unchanged)."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.uint32 else a


def to_tensor(a, device="cuda") -> torch.Tensor:
    return torch.from_numpy(as_int32(a).copy()).to(resolve_device(device))


def _field(src: Any, name: str):
    """Field ``name`` of a NamedTuple-like or dict ``src`` (None if it
    has none)."""
    return src.get(name) if isinstance(src, dict) else getattr(src, name,
                                                               None)


def _build(cls, src: Any, device) -> Any:
    return cls(**{k: to_tensor(_field(src, k), device)
                  for k in cls._fields})


def graph_arrays(src: Any, device="cuda") -> GraphArrays:
    """The port's graph view from a packed [V, W] adjacency array, or
    from the reference's ``GraphArrays`` lanes (a ``NamedTuple`` or a
    dict, dense or hierarchical). A hierarchical source carries its
    ``kmax`` as the length of its ``chunk_pad`` lane."""
    if _field(src, "chunk_data") is None:
        adj = _field(src, "adj_bitmap")
        adj = to_tensor(src if adj is None else adj, device)
        return GraphArrays(adj_bitmap=adj, n_vertices=int(adj.shape[0]))
    summary = to_tensor(_field(src, "adj_summary"), device)
    return GraphArrays(
        adj_bitmap=None, n_vertices=int(summary.shape[0]),
        adj_summary=summary,
        chunk_ptr=to_tensor(_field(src, "chunk_ptr"), device),
        chunk_id=to_tensor(_field(src, "chunk_id"), device),
        chunk_data=to_tensor(_field(src, "chunk_data"), device),
        kmax=int(np.asarray(_field(src, "chunk_pad")).shape[0]))


def query_bank(src: Any, device="cuda") -> QueryBank:
    return _build(QueryBank, src, device)


def store_bank(src: Any, device="cuda") -> PatternStoreBank:
    return _build(PatternStoreBank, src, device)


def stack_bank(src: Any, device="cuda") -> StackBank:
    return _build(StackBank, src, device)


def entries(src: dict) -> dict:
    """An entries dict (the reference's ``store_to_entries`` output or a
    ``PatternCache`` line) as the port's ``seed_patterns``: the same
    keys, copied with the port's dtypes."""
    dtypes = {"pos": np.int32, "v": np.int32, "phi": np.int32,
              "mu": np.int32, "mask": np.uint64, "hits": np.int64}
    return {k: np.array(src[k], dtype=dtypes[k]) for k in ENTRY_KEYS}


def to_numpy(nt: Any) -> dict:
    """Every tensor field of a port ``NamedTuple`` as a numpy array."""
    return {k: v.detach().cpu().numpy() for k, v in nt._asdict().items()
            if torch.is_tensor(v)}


# ------------------------------------------------------------ model zoo
def _flat(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree if torch.is_tensor(tree) else np.asarray(tree)


def flatten_params(tree, stacked=()) -> dict:
    """A reference parameter pytree (dicts, lists, arrays or tensors) as
    ``{name: array}`` in the port's naming: keys and list indices joined by
    ``.``; each top-level key in ``stacked`` (layers stacked on axis 0)
    split into one entry per layer, ``layers.<i>.<rest>``."""
    out: dict = {}
    for key, sub in tree.items():
        if key not in stacked:
            _flat(sub, f"{key}.", out)
            continue
        leaves: dict = {}
        _flat(sub, "", leaves)
        n = len(next(iter(leaves.values())))
        for i in range(n):
            out.update({f"{key}.{i}.{rest}": a[i]
                        for rest, a in leaves.items()})
    return out


def _param_tensor(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach()
    a = np.array(a, order="C")               # a copy; keeps 0-d leaves 0-d
    if a.dtype.name == "bfloat16":           # ml_dtypes: same bits as torch's
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_params(module: torch.nn.Module, tree, device="cuda", stacked=()):
    """``module`` (built on ``"meta"``) materialised on ``device`` with
    the reference tree's weights. Names, shapes and dtypes must match
    one to one."""
    flat = flatten_params(tree, stacked)
    module = module.to_empty(device=resolve_device(device))
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise KeyError(f"reference-only {sorted(set(flat) - set(params))}, "
                       f"port-only {sorted(set(params) - set(flat))}")
    with torch.no_grad():
        for name, p in params.items():
            t = _param_tensor(flat[name])
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{name}: reference {tuple(t.shape)} "
                                 f"{t.dtype}, port {tuple(p.shape)} "
                                 f"{p.dtype}")
            p.copy_(t)
    return module


def lm_params(tree, cfg, device="cuda"):
    """The port's ``LM`` from the reference's ``lm_init`` tree (layers
    unstacked, experts kept stacked)."""
    from .models.transformer import LM
    return load_params(LM(None, cfg, device="meta"), tree, device,
                       stacked=("layers",))


def gnn_params(tree, cfg, device="cuda"):
    from .models.gnn import GNN
    return load_params(GNN(None, cfg, device="meta"), tree, device)


def equiv_params(tree, cfg, device="cuda"):
    from .models.equivariant import Equiv
    return load_params(Equiv(None, cfg, device="meta"), tree, device)


def din_params(tree, cfg, device="cuda"):
    from .models.recsys import DIN
    return load_params(DIN(None, cfg, device="meta"), tree, device)


# ------------------------------------------------- back to the reference
def _stacked(module) -> tuple:
    """The top-level keys the reference stacks on axis 0 for ``module``:
    an LM's ``layers``."""
    from .models.transformer import LM
    return ("layers",) if isinstance(module, LM) else ()


def _ref_key(name: str, stacked) -> list:
    parts = [int(s) if s.isdigit() else s for s in name.split(".")]
    if parts[0] in stacked:          # layers.<i>.<rest> -> layers.<rest>.<i>
        parts = [parts[0], *parts[2:], parts[1]]
    return parts


def ref_order(module) -> dict:
    """``module.named_parameters()`` as a dict in the reference's flatten
    order (dict keys sorted, list indices in order, a stacked leaf's
    layers one after another)."""
    stacked = _stacked(module)
    named = dict(module.named_parameters())
    return {n: named[n] for n in sorted(named,
                                        key=lambda n: _ref_key(n, stacked))}


def decayed(module) -> set:
    """The names of ``module``'s parameters whose leaf in the reference's
    tree has ``ndim >= 2``: the reference's AdamW decays exactly those.
    A stacked layer's every tensor counts one dimension more, so an LM's
    per-layer norms and biases are decayed, ``ln_final`` is not."""
    stacked = _stacked(module)
    return {n for n, p in module.named_parameters()
            if p.ndim + (n.split(".")[0] in stacked) >= 2}


def _put(tree: dict, parts: list, leaf) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = leaf


def _listify(tree):
    """Nested dicts whose keys are all digits become lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _listify(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[k] for k in sorted(out, key=int)]
    return out


def _nest(named: dict, stacked=()) -> dict:
    """``{name: tensor}`` in the port's naming as the reference's tree
    (the inverse of ``flatten_params``): each leaf a detached copy, the
    per-layer leaves of every key in ``stacked`` stacked on axis 0."""
    tree: dict = {}
    layers: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in stacked:
            layers.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = t
        else:
            _put(tree, parts, t.detach().clone())
    for parts, per_layer in layers.items():
        _put(tree, list(parts), torch.stack(
            [per_layer[i].detach() for i in range(len(per_layer))]))
    return _listify(tree)


def lm_tree(model) -> dict:
    """The reference-shaped parameter tree of a port ``LM`` (layers
    stacked on axis 0, experts stacked as they are): ``lm_params`` of it
    gives back the same model bit for bit."""
    return _nest(dict(model.named_parameters()), ("layers",))


def gnn_tree(model) -> dict:
    return _nest(dict(model.named_parameters()))


def opt_tree(state: dict, model) -> dict:
    """The port's AdamW state (``training.optimizer``) as the reference's
    ``adamw_init`` tree for ``model``'s parameters."""
    stacked = _stacked(model)
    return {"m": _nest(state["m"], stacked),
            "step": state["step"].detach().clone(),
            "v": _nest(state["v"], stacked)}


def opt_state(tree: dict, model) -> dict:
    """The reverse of ``opt_tree``: the reference's optimizer tree as the
    port's AdamW state for ``model``, on ``model``'s device."""
    stacked = _stacked(model)
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device

    def moments(sub) -> dict:
        flat = flatten_params(sub, stacked)
        if set(flat) != set(params):
            raise KeyError(f"optimizer tree and model differ: "
                           f"{sorted(set(flat) ^ set(params))}")
        out = {}
        for n in params:
            t = _param_tensor(flat[n])
            out[n] = torch.empty(t.shape, dtype=t.dtype,
                                 device=device).copy_(t)
        return out
    step = _param_tensor(tree["step"]).to(device=device, dtype=torch.int32)
    return {"m": moments(tree["m"]), "v": moments(tree["v"]),
            "step": step.clone()}
