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


def nlf_filter(query: Graph, data: Graph,
               cand: list[np.ndarray]) -> list[np.ndarray]:
    """Neighbor-label-frequency refinement of an existing candidate list."""
    q_counts = query.neighbor_label_counts  # [nq, n_labels_q]
    d_counts = data.neighbor_label_counts   # [nd, n_labels_d]
    n_labels = min(q_counts.shape[1], d_counts.shape[1])
    out = []
    for u in range(query.n):
        need = q_counts[u]
        cands = cand[u]
        if len(cands) == 0:
            out.append(cands)
            continue
        have = d_counts[cands]
        ok = np.all(have[:, :n_labels] >= need[None, :n_labels], axis=1)
        # any query label beyond the data alphabet kills all candidates
        if need[n_labels:].any():
            ok &= False
        out.append(cands[ok])
    return out


def _refine_once(query: Graph, data: Graph,
                 cand_masks: list[np.ndarray]) -> bool:
    """One sweep of edge-consistency refinement (AC-ish / CFL passes).

    cand_masks[u] is a boolean mask over data vertices. A candidate v of u
    survives only if, for every query neighbor u', v has at least one data
    neighbor that is a candidate of u'. Returns True if anything changed.
    """
    changed = False
    nnz = data.indices.size
    # one reduceat over the data CSR per (u, u') pair instead of a
    # Python loop over candidates — the per-vertex generator dominated
    # submit latency on the serving path. The segment sum counts a
    # vertex's neighbors that are candidates of u'; empty rows read a
    # garbage segment and are masked via ``nonempty``.
    starts = np.minimum(data.indptr[:-1], max(nnz - 1, 0))
    nonempty = (data.indptr[1:] - data.indptr[:-1]) > 0
    for u in range(query.n):
        mask_u = cand_masks[u]
        if not mask_u.any():
            continue
        keep = mask_u.copy()
        for uq in query.neighbors(u):
            if nnz == 0:
                keep[:] = False
                break
            m_other = cand_masks[int(uq)]
            # v survives iff any neighbor of v is in m_other
            hit = np.add.reduceat(m_other[data.indices], starts) > 0
            keep &= nonempty & hit
            if not keep.any():
                break
        if not np.array_equal(keep, mask_u):
            changed = True
            cand_masks[u] = keep
    return changed


def cfl_refine(query: Graph, data: Graph, cand: list[np.ndarray],
               max_rounds: int = 3) -> list[np.ndarray]:
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
        if not _refine_once(query, data, masks):
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
            cand = nlf_filter(query, data, cand)
    if use_cfl:
        with maybe(spans, "cfl"):
            cand = cfl_refine(query, data, cand)
    return cand
