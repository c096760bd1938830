"""Data graphs, built once per checkout and loaded on later runs.

A configuration's ``graph`` block names its generator (a file
``portbench/datasets/<generator>.py`` with ``build(params, seed)``), the
generator's parameters and the graph seed. The graph is kept as CSR in
``portbench/.cache/<config>-<digest>.npz``; the digest covers the
generator's source, this file's source, the parameters and the seed, so
a changed generator or layout rebuilds. The file is written under a
temporary name and renamed, so a run that is cut leaves no torn file.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CACHE_DIR = HERE.parent / ".cache"


def generator_module(name: str):
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no generator file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_generator_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(graph: dict, here: Path = HERE) -> str:
    h = hashlib.sha256()
    h.update((Path(here) / f"{graph['generator']}.py").read_bytes())
    h.update(Path(__file__).read_bytes())
    h.update(json.dumps(graph, sort_keys=True).encode())
    return h.hexdigest()[:16]


def to_csr(n: int, src: np.ndarray, dst: np.ndarray
           ) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric CSR (``indptr`` int32 [n + 1], ``indices`` int32, each
    row sorted) of an undirected edge list given once per edge."""
    a = np.concatenate([src, dst]).astype(np.int64)
    b = np.concatenate([dst, src]).astype(np.int64)
    order = np.lexsort((b, a))
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(a, minlength=n))
    return indptr.astype(np.int32), b[order].astype(np.int32)


def build(graph: dict) -> dict:
    """The graph of a configuration's ``graph`` block, freshly built."""
    gen = generator_module(graph["generator"])
    n, labels, src, dst, n_labels = gen.build(graph["params"],
                                              int(graph["seed"]))
    indptr, indices = to_csr(n, src, dst)
    return {"n": int(n), "labels": np.asarray(labels, np.int32),
            "indptr": indptr, "indices": indices,
            "n_labels": int(n_labels)}


def load(name: str, graph: dict, cache_dir: Path = CACHE_DIR
         ) -> tuple[dict, bool]:
    """``(arrays, built)``: the cached graph of configuration ``name``,
    or a fresh build saved to the cache (``built`` True)."""
    path = Path(cache_dir) / f"{name}-{digest(graph)}.npz"
    if path.is_file():
        with np.load(path) as z:
            arrays = {k: z[k] for k in ("labels", "indptr", "indices")}
            arrays["n"] = int(z["n"])
            arrays["n_labels"] = int(z["n_labels"])
        return arrays, False
    arrays = build(graph)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.partial.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return arrays, True
