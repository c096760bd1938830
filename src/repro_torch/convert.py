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
           "equiv_params", "din_params"]


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
        out[prefix[:-1]] = np.asarray(tree)


def flatten_params(tree, stacked=()) -> dict:
    """A reference parameter pytree (dicts, lists, arrays) as ``{name:
    numpy array}`` in the port's naming: keys and list indices joined by
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


def _param_tensor(a: np.ndarray) -> torch.Tensor:
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
