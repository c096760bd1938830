"""Frozen data-graph generator of the benchmark: preferential attachment.

Sun & Luo's datasets (SIGMOD 2020) cannot be had offline, so each
configuration's data graph is made from its graph seed by a generator
that matches the dataset's |V|, |E| and |Sigma|. The pattern is the
port's own generator family (``repro_torch.data.graph_gen``: preferential
attachment plus uniform random edges, Zipf-like labels, optionally
relabelled in degree-descending order), rewritten so that no step loops
over vertices in Python: the attachment targets are drawn all at once
and resolved by pointer doubling.

This file is part of the yardstick. The dataset cache keys every graph
by a digest of this source, so a change here rebuilds every graph.

A configuration names its generator by file name; the harness calls the
file's ``build(params, seed)``, which returns ``(n, labels, src, dst,
n_labels)``: the undirected edge list with ``src < dst``, each edge
once, sorted.
"""
from __future__ import annotations

import numpy as np


def zipf_labels(rng: np.random.Generator, n: int, n_labels: int,
                s: float = 1.1) -> np.ndarray:
    """Labels with weights ``1 / rank**s``; every label appears at
    least once (the first ``n_labels`` vertices take one each)."""
    w = 1.0 / np.arange(1, n_labels + 1) ** s
    w /= w.sum()
    labels = rng.choice(n_labels, size=n, p=w)
    labels[:n_labels] = np.arange(n_labels)
    return labels.astype(np.int32)


def attachment_edges(rng: np.random.Generator, n: int, m: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Preferential attachment: vertex ``m`` joins ``0..m-1``, then each
    later vertex ``v`` draws ``m`` targets with probability proportional
    to degree (a uniform draw from the endpoint list so far).

    The endpoint list has a fixed layout: vertex ``v``'s block holds its
    ``m`` drawn targets, then ``m`` copies of ``v``. A drawn target is a
    copy of an earlier entry, so every entry resolves to a fixed one by
    pointer doubling. Repeated targets of one vertex give one edge (the
    endpoint list keeps both copies, as the degree weight of a multigraph
    would)."""
    if n <= m + 1:
        a, b = np.triu_indices(n, 1)
        return a.astype(np.int64), b.astype(np.int64)
    size = 2 * m * (n - m)
    value = np.empty(size, np.int64)
    ptr = np.arange(size, dtype=np.int64)
    value[:m] = m
    value[m:2 * m] = np.arange(m)
    blocks = np.arange(n - m - 1, dtype=np.int64)          # v = m + 1 + b
    start = 2 * m + 2 * m * blocks                         # block offsets
    tgt = (start[:, None] + np.arange(m)).reshape(-1)      # drawn slots
    own = (start[:, None] + m + np.arange(m)).reshape(-1)  # copies of v
    value[own] = np.repeat(m + 1 + blocks, m)
    # a draw for the block at offset P is uniform over entries [0, P)
    lim = np.repeat(start, m)
    ptr[tgt] = np.floor(rng.random(tgt.size) * lim).astype(np.int64)
    fixed = np.ones(size, bool)
    fixed[tgt] = False
    while not fixed[ptr].all():
        ptr = np.where(fixed[ptr], ptr, ptr[ptr])
    value[tgt] = value[ptr[tgt]]
    src = np.concatenate([np.full(m, m, np.int64),
                          np.repeat(m + 1 + blocks, m)])
    dst = np.concatenate([np.arange(m, dtype=np.int64), value[tgt]])
    return src, dst


def unique_edges(n: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sorted keys ``lo * n + hi`` of the distinct non-loop edges."""
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    keep = lo != hi
    return np.unique(lo[keep] * n + hi[keep])


def top_up(rng: np.random.Generator, n: int, keys: np.ndarray,
           n_edges: int) -> np.ndarray:
    """Add uniform random edges to ``keys`` until exactly ``n_edges``
    distinct edges remain (in rounds of vectorized draws)."""
    while keys.size < n_edges:
        need = n_edges - keys.size
        a = rng.integers(0, n, size=need + need // 8 + 16)
        b = rng.integers(0, n, size=a.size)
        new = unique_edges(n, a, b)
        new = new[~np.isin(new, keys, assume_unique=True)]
        # draw order, not key order, picks which fresh edges are kept
        new = rng.permutation(new)[:need]
        keys = np.union1d(keys, new)
    return keys


def degree_sorted(n: int, labels: np.ndarray, keys: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Relabel so hubs take the low ids (stable degree-descending
    order, as ``core.graph.degree_descending_order``)."""
    lo, hi = keys // n, keys % n
    deg = np.bincount(lo, minlength=n) + np.bincount(hi, minlength=n)
    order = np.argsort(-deg, kind="stable")
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    return labels[order], unique_edges(n, inv[lo], inv[hi])


def build(params: dict, seed: int):
    """The configuration's graph: ``attach`` targets per vertex by
    preferential attachment, topped up with uniform random edges to
    exactly ``n_edges``, Zipf labels over ``n_labels``, and relabelled
    by degree where ``degree_sorted`` is set."""
    n, m = int(params["n_vertices"]), int(params["attach"])
    n_edges, n_labels = int(params["n_edges"]), int(params["n_labels"])
    rng = np.random.default_rng(seed)
    a, b = attachment_edges(rng, n, m)
    keys = unique_edges(n, a, b)
    if keys.size > n_edges:
        raise ValueError(f"attachment alone gives {keys.size} edges, "
                         f"more than the {n_edges} asked for")
    keys = top_up(rng, n, keys, n_edges)
    labels = zipf_labels(rng, n, n_labels)
    if params.get("degree_sorted", False):
        labels, keys = degree_sorted(n, labels, keys)
    return n, labels, keys // n, keys % n, n_labels

