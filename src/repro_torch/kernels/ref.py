"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each function here computes exactly what its kernel computes and is what
the wrapper runs for a CPU tensor (or under ``backend_scope("torch")``).
"""
from __future__ import annotations

import torch


def refine_bitmap_rows_ref(adj_bitmap: torch.Tensor, cand_rows: torch.Tensor,
                           frontier: torch.Tensor, active: torch.Tensor
                           ) -> torch.Tensor:
    """Per-row Eq. 2 refinement:

        out[i] = cand[i] & AND_{p: active[i,p] != 0 and frontier[i,p] >= 0}
                 adj[frontier[i, p]]

    ``adj_bitmap`` int32 [V, W], ``cand_rows`` int32 [F, W], ``frontier``
    and ``active`` int32 [F, NP]; returns int32 [F, W]. A frontier vertex
    past V - 1 reads row V - 1, as the reference kernel clamps it.

    Torch has no AND-reduction, so the gathered [F, NP, W] rows (inactive
    ones replaced by all-ones) are folded pairwise: log2(NP) ANDs.
    """
    v = adj_bitmap.shape[0]
    f, np_ = frontier.shape
    act = (active != 0) & (frontier >= 0)
    rows = adj_bitmap[frontier.clamp(0, v - 1).reshape(-1)].reshape(
        f, np_, -1)
    rows = torch.where(act[:, :, None], rows,
                       torch.full((), -1, dtype=rows.dtype,
                                  device=rows.device))
    while rows.shape[1] > 1:
        if rows.shape[1] % 2:
            rows = torch.cat([rows, torch.full_like(rows[:, :1], -1)], 1)
        half = rows.shape[1] // 2
        rows = rows[:, :half] & rows[:, half:]
    if np_ == 0:
        return cand_rows.clone()
    return cand_rows & rows[:, 0]
