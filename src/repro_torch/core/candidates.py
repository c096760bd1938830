"""Candidate filtering for subgraph matching.

Produces, for every query vertex ``u``, the candidate set ``C[u]`` of data
vertices it may be mapped onto. Three filters of increasing strength, each
sound (never removes a vertex that participates in some embedding):

* LDF  — label + degree filter (Ullmann / Eq. 1 plus degree test).
* NLF  — neighbor-label-frequency filter (GraphQL/SPath style): ``v`` must
  have at least as many neighbors of each label as ``u`` does.
* CFL-lite — BFS-tree forward/backward refinement in the spirit of
  CFL-Match/TurboISO: a candidate survives only if every tree child/parent
  query vertex has at least one *adjacent* surviving candidate. Iterated to
  a fixpoint over the full query graph (stronger than tree-only).

The paper's method composes with these ("we can also combine our method and
structural analyses"); our default pipeline is LDF + NLF + CFL-lite, which
mirrors the paper's evaluation setup (they build on CFL-Match pruning).
"""
from __future__ import annotations

import numpy as np

from .graph import Graph
from .spans import Spans, maybe


def ldf_filter(query: Graph, data: Graph) -> list[np.ndarray]:
    """Label + degree filter: C[u] = {v : l(v)=l(u), deg(v) >= deg(u)}."""
    out: list[np.ndarray] = []
    deg = data.degrees
    for u in range(query.n):
        lab = int(query.labels[u])
        cands = data.label_index.get(lab, np.empty(0, np.int32))
        cands = cands[deg[cands] >= query.degree(u)]
        out.append(np.sort(cands).astype(np.int32))
    return out


def nlf_filter(query: Graph, data: Graph, cand: list[np.ndarray],
               spans: Spans | None = None) -> list[np.ndarray]:
    """Neighbor-label-frequency refinement of an existing candidate list.

    The data graph's table is built on its first use and kept by the
    graph (counted as ``nlf_table_builds`` in ``spans``); each query
    vertex then reads only its candidates' rows, at the labels it needs.
    """
    # a graph without the cache (the reference's) builds on every call
    if spans is not None and getattr(data, "_nlf_counts", None) is None:
        spans.count("nlf_table_builds")
    q_counts = query.neighbor_label_counts  # [nq, n_labels_q]
    d_counts = data.neighbor_label_counts   # [nd, n_labels_d]
    n_labels = min(q_counts.shape[1], d_counts.shape[1])
    out = []
    for u in range(query.n):
        need = q_counts[u]
        cands = cand[u]
        # any query label beyond the data alphabet kills all candidates
        if len(cands) == 0 or need[n_labels:].any():
            out.append(cands[:0])
            continue
        labs = np.flatnonzero(need[:n_labels])
        ok = np.all(d_counts[cands[:, None], labs] >= need[labs], axis=1)
        out.append(cands[ok])
    return out


# A sweep reduces over the CSR rows of u's current candidates (gathered
# once per u) while their degree sum is under this share of the data
# graph's nnz, and over the whole CSR above it, where building the
# gather costs more than it saves. Measured on one host core (8-vertex
# queries on 4674-vertex, 86,282-edge random graphs of 1-6 labels):
# always gathering took 2.3x the whole-CSR sweep where the candidates
# cover every vertex, always sweeping the whole CSR 1.9x the gather at
# a mean share of 0.26; a crossover of 0.4-0.5 was within noise of the
# best on every graph.
GATHER_MAX_SHARE = 0.4


def _rows_of(data: Graph, rows: np.ndarray
             ) -> tuple[np.ndarray, np.ndarray]:
    """The CSR entries of ``rows`` concatenated, and the offset of each
    row's first entry among them."""
    start = data.indptr[rows].astype(np.intp)
    deg = data.indptr[rows + 1] - start
    offs = np.cumsum(deg) - deg
    pos = np.arange(deg.sum()) + np.repeat(start - offs, deg)
    return data.indices[pos].astype(np.intp), offs


def _refine_once(query: Graph, data: Graph, cand_masks: list[np.ndarray],
                 spans: Spans | None = None) -> bool:
    """One sweep of edge-consistency refinement (AC-ish / CFL passes).

    cand_masks[u] is a boolean mask over data vertices. A candidate v of u
    survives only if, for every query neighbor u', v has at least one data
    neighbor that is a candidate of u'. Returns True if anything changed.

    Only the rows of u's candidates are reduced: a vertex outside
    ``cand_masks[u]`` stays out whatever its row holds, so the result is
    the whole-CSR sweep's. ``cand_masks[u]`` is replaced once its query
    neighbors are done (Gauss-Seidel: a later u reads it). The rows
    reduced are counted as ``cfl_rows`` in ``spans``.
    """
    changed = False
    deg = data.degrees
    nnz = data.indices.size
    whole = None
    n_rows = 0
    for u in range(query.n):
        mask_u = cand_masks[u]
        q_nbrs = query.neighbors(u)
        if len(q_nbrs) == 0 or not mask_u.any():
            continue
        cands = np.flatnonzero(mask_u)
        # an empty row has no neighbor in any mask
        rows = cands[deg[cands] > 0]
        if deg[rows].sum() < GATHER_MAX_SHARE * nnz:
            nbrs, offs = _rows_of(data, rows)
            alive = np.ones(len(rows), bool)
        else:
            if whole is None:
                nonempty = np.flatnonzero(deg > 0)
                whole = (nonempty, data.indices.astype(np.intp),
                         data.indptr[nonempty])
            rows, nbrs, offs = whole
            alive = mask_u[rows]
        if len(rows):
            for uq in q_nbrs:
                n_rows += len(rows)
                # v keeps iff some neighbor of v is a candidate of uq
                alive &= np.logical_or.reduceat(
                    cand_masks[int(uq)][nbrs], offs)
                if not alive.any():
                    break
        kept = rows[alive]
        if len(kept) != len(cands):
            changed = True
            keep = np.zeros(data.n, dtype=bool)
            keep[kept] = True
            cand_masks[u] = keep
    if spans is not None:
        spans.count("cfl_rows", n_rows)
    return changed


def cfl_refine(query: Graph, data: Graph, cand: list[np.ndarray],
               max_rounds: int = 3,
               spans: Spans | None = None) -> list[np.ndarray]:
    """Fixpoint edge-consistency refinement (bounded rounds).

    Strictly sound: only candidates provably absent from every embedding
    are removed (they lack an adjacent candidate for some query neighbor).
    """
    masks = []
    for u in range(query.n):
        m = np.zeros(data.n, dtype=bool)
        m[cand[u]] = True
        masks.append(m)
    for _ in range(max_rounds):
        if not _refine_once(query, data, masks, spans):
            break
    return [np.nonzero(m)[0].astype(np.int32) for m in masks]


def build_candidates(query: Graph, data: Graph,
                     use_nlf: bool = True,
                     use_cfl: bool = True,
                     spans: Spans | None = None) -> list[np.ndarray]:
    """Default filtering pipeline: LDF (+NLF) (+CFL-lite fixpoint); each
    filter is a span (``ldf``, ``nlf``, ``cfl``) of ``spans`` when given."""
    with maybe(spans, "ldf"):
        cand = ldf_filter(query, data)
    if use_nlf:
        with maybe(spans, "nlf"):
            cand = nlf_filter(query, data, cand, spans=spans)
    if use_cfl:
        with maybe(spans, "cfl"):
            cand = cfl_refine(query, data, cand, spans=spans)
    return cand
