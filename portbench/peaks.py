"""Published peaks of the cards a run may land on, and the byte count
of a kernel call that a roofline share divides by.

NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense rates, at the full
700 W power limit): 3.35 TB/s of HBM3. A card whose name matches no
entry has no peak, and a roofline share is then not reported.
"""
from __future__ import annotations

HBM_BYTES_PER_S = {"H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(kind: str) -> float | None:
    for key, value in HBM_BYTES_PER_S.items():
        if key in kind:
            return value
    return None


def dense_refine_bytes(n_rows: int, n_words: int, n_positions: int,
                       distinct_adj_rows: int) -> int:
    """Least bytes one dense refine call (``refine_bitmap_rows``) must
    move: each of its ``n_rows`` candidate rows of ``n_words`` int32
    words read once and each output row written once, each distinct
    adjacency row its active positions name read once, and the
    ``frontier`` and ``active`` int32 [n_rows, n_positions] inputs read
    once. A row read again by another wave row is not counted again."""
    return 4 * (n_words * (2 * n_rows + distinct_adj_rows)
                + 2 * n_rows * n_positions)
