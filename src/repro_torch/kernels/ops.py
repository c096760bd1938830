"""The kernel-op layer: public entry points to the port's kernels, the
twin of the reference's ``repro.kernels.ops``.

Every op takes ``backend`` in the port's names, for that call only (it
is handed to the wrapper; no process-wide state changes):

  * ``None``    — the tensor decides (``config.backend_for``): a CUDA
                  tensor goes to the kernel, a CPU tensor to the plain
                  version, unless a backend is forced process-wide
                  (``set_backend`` / ``REPRO_TORCH_KERNEL_BACKEND``);
  * ``"torch"`` — the plain PyTorch version (``ref.py``), on any device;
  * ``"cuda"``  — the hand-written CUDA kernel; raises for a CPU tensor.

Packed words are int32 tensors holding the bit patterns of the
reference's uint32 words (``convert.as_int32`` / ``convert.to_tensor``),
and the refine ops return int32 where the reference returns uint32.
"""
from __future__ import annotations

import torch

from .bitmap_refine import refine_bitmap_rows, refine_bitmap_rows_hier
from .bitmap_spmm import bitmap_spmm
from .config import get_backend, set_backend
from .flash_attention import flash_attention

__all__ = ["refine_bitmap_op", "refine_bitmap_rows_op",
           "refine_bitmap_rows_hier_op", "bitmap_spmm_op",
           "flash_attention_op", "get_backend", "set_backend"]


def refine_bitmap_rows_op(adj_bitmap, cand_rows, frontier, active,
                          backend: str | None = None,
                          block_f: int | None = None) -> torch.Tensor:
    """Eq. 2 packed-bitmap refinement with per-row candidate/active sets
    (the multi-query wave layout). int32 [V, W], [F, W], [F, NP],
    [F, NP]; returns int32 [F, W]. ``block_f`` is accepted for parity
    with the reference and not read."""
    return refine_bitmap_rows(adj_bitmap, cand_rows, frontier, active,
                              backend=backend)


def refine_bitmap_rows_hier_op(summary, chunk_ptr, chunk_id, chunk_data,
                               kmax, cand_rows, frontier, active,
                               backend: str | None = None,
                               dma_depth: int | None = None
                               ) -> torch.Tensor:
    """Eq. 2 refinement over the two-level adjacency layout
    (``core.graph.HierBitmap``); bit-identical to
    :func:`refine_bitmap_rows_op` on the same graph. Returns int32
    [F, W]."""
    return refine_bitmap_rows_hier(summary, chunk_ptr, chunk_id, chunk_data,
                                   int(kmax), cand_rows, frontier, active,
                                   dma_depth=dma_depth, backend=backend)


def refine_bitmap_op(adj_bitmap, cand_row, frontier, active,
                     backend: str | None = None,
                     block_f: int | None = None) -> torch.Tensor:
    """Eq. 2 refinement with one shared candidate row [W] and one shared
    active vector [NP] (the single-query layout), broadcast over the F
    frontier rows. Returns int32 [F, W]."""
    f = frontier.shape[0]
    cand_rows = cand_row[None, :].expand(f, -1).contiguous()
    act = active[None, :].expand(f, -1).contiguous()
    return refine_bitmap_rows_op(adj_bitmap, cand_rows, frontier, act,
                                 backend=backend, block_f=block_f)


def bitmap_spmm_op(adj_words, x, backend: str | None = None,
                   block_i: int = 256, block_j: int = 256) -> torch.Tensor:
    """Packed-bitmap SpMM ``A @ x``. Returns [N, D] in x.dtype."""
    return bitmap_spmm(adj_words, x, block_i=block_i, block_j=block_j,
                       backend=backend)


def flash_attention_op(q, k, v, causal: bool = True,
                       backend: str | None = None,
                       block_q: int = 128, block_k: int = 128
                       ) -> torch.Tensor:
    """Fused attention forward [B, H, S, D] (GQA-aware; causal mask
    top-left aligned, as the reference's Pallas kernel has it).

    Card limits: the CUDA kernels take head sizes D <= 256
    (``flash_attention.MAX_HEAD_DIM``) in float32 or bfloat16 only, and
    raise for anything else (``flash_attention.plan`` names the limit);
    the plain version takes any D and float dtype. The reference pads
    any D to a multiple of 128 instead."""
    return flash_attention(q, k, v, causal=causal, block_q=block_q,
                           block_k=block_k, backend=backend)
