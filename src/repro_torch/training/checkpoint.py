"""Atomic, resumable checkpointing in the reference's on-disk format
(twin of ``repro.training.checkpoint``: either package restores the
other's checkpoints bit for bit).

Layout per step::

    <dir>/step_000123.tmp-<nonce>/   (written, manifest fsynced)
        manifest.json                (tree descriptor, shapes, dtypes,
                                      specs, step, extra)
        arrays.npz                   (flattened leaves by index)
    <dir>/step_000123/               (atomic rename when complete)

A tree is dicts, lists, tuples and ``None`` over leaves (tensors, numpy
arrays or scalars). Leaf ``a<i>`` is the i-th leaf in JAX's flatten
order of the same tree: dict keys sorted, lists and tuples by index,
``None`` no leaf (``tree_flatten``); the manifest's ``treedef`` is
written in ``jax``'s own notation, and its ``n_leaves``, ``dtypes`` and
``shapes`` are what the reference's ``restore`` reads. bfloat16 leaves
are stored as uint16 with ``"bfloat16"`` in ``dtypes``, so no numpy
bfloat16 type is needed on either side.

Guarantees:
  * crash-safe — a checkpoint is visible only after the atomic rename;
    stale ``.tmp-*`` directories are garbage-collected on save.
  * bounded — keeps the newest ``keep`` checkpoints.

``specs`` is a tree of strings or ``None`` matching the tree up to its
leaves (the port has no ``PartitionSpec`` yet); ``restore`` places every
leaf on one device.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import time
import uuid

import numpy as np
import torch

from ..kernels.config import resolve_device

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
LEAF = object()          # a leaf's place in a ``TreeDef``


class TreeDef:
    """The structure of a tree with its leaves taken out."""

    def __init__(self, node):
        self.node = node

    def unflatten(self, leaves):
        it = iter(leaves)
        out = _fill(self.node, it)
        if next(it, LEAF) is not LEAF:
            raise ValueError("more leaves than the tree has")
        return out

    def flatten_up_to(self, tree) -> list:
        """The subtrees of ``tree`` at this structure's leaves, in order
        (``tree`` must have this structure down to them)."""
        out: list = []
        _up_to(self.node, tree, out)
        return out

    def __str__(self) -> str:
        return f"PyTreeDef({_show(self.node)})"


def _children(tree) -> list:
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree)


def _structure(tree, leaves: list):
    if tree is None:
        return None
    if isinstance(tree, (dict, list, tuple)):
        kids = [_structure(c, leaves) for c in _children(tree)]
        if isinstance(tree, dict):
            return dict(zip(sorted(tree), kids))
        return type(tree)(kids)
    leaves.append(tree)
    return LEAF


def tree_flatten(tree) -> tuple[list, TreeDef]:
    """(leaves in JAX's flatten order, the tree's ``TreeDef``)."""
    leaves: list = []
    return leaves, TreeDef(_structure(tree, leaves))


def _fill(node, it):
    if node is LEAF:
        return next(it)
    if node is None:
        return None
    kids = [_fill(c, it) for c in _children(node)]
    if isinstance(node, dict):
        return dict(zip(sorted(node), kids))
    return type(node)(kids)


def _up_to(node, tree, out: list) -> None:
    if node is LEAF:
        out.append(tree)
        return
    if node is None:
        if tree is not None:
            raise ValueError(f"expected None, got {type(tree).__name__}")
        return
    if type(tree) is not type(node) or len(tree) != len(node) or (
            isinstance(node, dict) and sorted(tree) != sorted(node)):
        raise ValueError("tree structures differ")
    for n, t in zip(_children(node), _children(tree)):
        _up_to(n, t, out)


def _show(node) -> str:
    if node is LEAF:
        return "*"
    if node is None:
        return "None"
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_show(node[k])}"
                               for k in sorted(node)) + "}"
    body = ", ".join(_show(c) for c in node)
    if isinstance(node, tuple):
        return "(" + body + ("," if len(node) == 1 else "") + ")"
    return "[" + body + "]"


def _host(leaf) -> tuple[np.ndarray, str]:
    """(the leaf as a numpy array to store, its dtype's name)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if arr.dtype.kind == "V" or name == "bfloat16":
        arr = arr.view(np.uint16)    # npz-safe; dtype in manifest
    return arr, name


def save(ckpt_dir: str | pathlib.Path, step: int, tree,
         specs=None, extra: dict | None = None, keep: int = 3) -> pathlib.Path:
    """Write a checkpoint atomically; returns the final directory."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:09d}"
    tmp = ckpt_dir / f"step_{step:09d}.tmp-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    leaves, treedef = tree_flatten(tree)
    stored = [_host(leaf) for leaf in leaves]
    np.savez(tmp / ARRAYS, **{f"a{i}": arr
                              for i, (arr, _) in enumerate(stored)})
    spec_leaves = None
    if specs is not None:
        spec_leaves = [str(s) for s in treedef.flatten_up_to(specs)]
    manifest = {
        "step": int(step),
        "treedef": str(treedef),
        "n_leaves": len(leaves),
        "dtypes": [name for _, name in stored],
        "shapes": [list(arr.shape) for arr, _ in stored],
        "specs": spec_leaves,
        "extra": extra or {},
        "time": time.time(),
    }
    with open(tmp / MANIFEST, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    # GC: stale tmp dirs + old checkpoints beyond ``keep``
    for p in ckpt_dir.glob("step_*.tmp-*"):
        shutil.rmtree(p, ignore_errors=True)
    done = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir()
                  and ".tmp-" not in p.name)
    for p in done[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
    return final


def latest_step(ckpt_dir: str | pathlib.Path) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if p.is_dir() and ".tmp-" not in p.name
             and (p / MANIFEST).exists()]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str | pathlib.Path, template, step: int | None = None,
            device="cuda"):
    """Restore into the structure of ``template`` (its leaves need only a
    ``shape``: tensors on ``"meta"`` will do), every leaf a tensor on
    ``device``. Returns (tree, step, extra)."""
    device = resolve_device(device)
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:09d}"
    manifest = json.loads((d / MANIFEST).read_text())
    leaves, treedef = tree_flatten(template)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"leaf count mismatch: ckpt {manifest['n_leaves']}"
                         f" vs {len(leaves)}")
    out = []
    with np.load(d / ARRAYS) as data:
        for i, tmpl in enumerate(leaves):
            t = _tensor(data[f"a{i}"], manifest["dtypes"][i])
            want_shape = tuple(getattr(tmpl, "shape", t.shape))
            if tuple(t.shape) != want_shape:
                raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != "
                                 f"template {want_shape}")
            out.append(t.to(device))
    return treedef.unflatten(out), manifest["step"], manifest["extra"]
