"""Eq. 2 refinement kernels: wrappers and launch counts.

:func:`refine_bitmap_rows` is the port of the reference's Pallas kernel
of the same name (``repro/kernels/bitmap_refine.py``), over the dense
packed adjacency; :func:`refine_bitmap_rows_hier` ports
``refine_bitmap_rows_hier``, over the two-level layout
(``core.graph.HierBitmap``) that graphs of 16384 or more vertices use.
For a CUDA tensor each launches its hand-written kernel in ``csrc/``
(built and loaded by ``build.py``); for a CPU tensor it runs its plain
version in ``ref.py``. There is no fallback from one to the other: a
CUDA call either launches or raises. Neither takes a ``DTensor``: a
kernel reads its inputs by address, and a mesh step launches it on each
rank's local tensors (``core.engine_step``'s split refine).
"""
from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor

from . import build
from .config import backend_for
from .ref import refine_bitmap_rows_hier_ref, refine_bitmap_rows_ref

MAX_POSITIONS = 64

LAUNCHES = 0            # kernel launches made by refine_bitmap_rows
HIER_LAUNCHES = 0       # kernel launches made by refine_bitmap_rows_hier

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "refine_bitmap_rows": {
        "refine_bitmap_rows_launch": ([_P] * 5 + [_I] * 4 + [_P], _I)},
    "refine_bitmap_rows_hier": {
        "refine_bitmap_rows_hier_launch": ([_P] * 8 + [_I] * 6 + [_P], _I),
        "refine_bitmap_rows_hier_max_smem": ([], _I)}}


def _library(name: str = "refine_bitmap_rows") -> ctypes.CDLL:
    return build.load(name, SIGNATURES[name])


def _no_dtensor(**args) -> None:
    """Raise ``TypeError`` naming the first ``DTensor`` argument."""
    for name, t in args.items():
        if isinstance(t, DTensor):
            raise TypeError(f"{name} is a DTensor: the refine kernels take "
                            "each rank's local tensors (to_local())")


def _checked(name: str, t: torch.Tensor, device: torch.device,
             ndim: int) -> torch.Tensor:
    """``t`` as the kernel reads it: on ``device``, int32, ``ndim``-D,
    contiguous (a strided view is copied)."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    return t.contiguous()


def hier_smem_bytes(n_words: int, n_summary: int) -> int:
    """Dynamic shared memory (bytes) the hierarchical kernel takes for a
    row of ``n_words`` words with ``n_summary`` summary words: the row
    in 16-byte units and the positions' summary intersection
    (``csrc/bitmap_refine_hier.cu``)."""
    return 4 * (4 * -(-n_words // 4) + n_summary)


def hier_max_smem() -> int:
    """This card's opt-in shared-memory limit (bytes) for the
    hierarchical kernel; builds its library if need be."""
    limit = _library("refine_bitmap_rows_hier"
                     ).refine_bitmap_rows_hier_max_smem()
    if limit < 0:
        raise RuntimeError(f"refine_bitmap_rows_hier: CUDA error {-limit} "
                           "reading the shared-memory limit")
    return limit


def refine_bitmap_rows(adj_bitmap: torch.Tensor, cand_rows: torch.Tensor,
                       frontier: torch.Tensor, active: torch.Tensor,
                       backend: str | None = None) -> torch.Tensor:
    """Eq. 2 refinement with per-row candidates and active positions.

    ``adj_bitmap`` int32 [V, W], ``cand_rows`` int32 [F, W], ``frontier``
    int32 [F, NP] (-1 unmapped), ``active`` int32 [F, NP]; returns int32
    [F, W]. Same semantics as ``ref.refine_bitmap_rows_ref``.
    ``backend`` names this call's backend (``config.backend_for``). The
    CUDA kernel reads a strided input from a contiguous copy. A
    ``DTensor`` argument raises ``TypeError``.
    """
    _no_dtensor(adj_bitmap=adj_bitmap, cand_rows=cand_rows,
                frontier=frontier, active=active)
    if backend_for(cand_rows, backend) == "torch":
        return refine_bitmap_rows_ref(adj_bitmap, cand_rows, frontier,
                                      active)
    global LAUNCHES
    dev = cand_rows.device
    adj_bitmap, cand_rows, frontier, active = (
        _checked(name, t, dev, 2) for name, t in (
            ("adj_bitmap", adj_bitmap), ("cand_rows", cand_rows),
            ("frontier", frontier), ("active", active)))
    v, w = adj_bitmap.shape
    f, np_ = frontier.shape
    if cand_rows.shape != (f, w) or active.shape != (f, np_):
        raise ValueError("shape mismatch: adj [V, W], cand [F, W], "
                         "frontier/active [F, NP]")
    if np_ > MAX_POSITIONS or v < 1:
        raise ValueError(f"need 1 <= V and NP <= {MAX_POSITIONS}")
    out = torch.empty_like(cand_rows)
    if f == 0 or w == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library("refine_bitmap_rows").refine_bitmap_rows_launch(
        adj_bitmap.data_ptr(), cand_rows.data_ptr(), frontier.data_ptr(),
        active.data_ptr(), out.data_ptr(), v, w, f, np_, stream)
    if err != 0:
        raise RuntimeError(f"refine_bitmap_rows launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out


def refine_bitmap_rows_hier(summary: torch.Tensor, chunk_ptr: torch.Tensor,
                            chunk_id: torch.Tensor, chunk_data: torch.Tensor,
                            kmax: int, cand_rows: torch.Tensor,
                            frontier: torch.Tensor, active: torch.Tensor,
                            dma_depth: int | None = None,
                            backend: str | None = None) -> torch.Tensor:
    """Eq. 2 refinement over the two-level adjacency layout.

    ``summary`` int32 [V, SW], ``chunk_ptr`` int32 [V + 1], ``chunk_id``
    int32 [P + kmax], ``chunk_data`` int32 [P + kmax, C] (C a power of
    two <= 128), ``kmax`` the layout's most stored chunks on a row;
    ``cand_rows`` int32 [F, W], ``frontier`` / ``active`` int32 [F, NP].
    Returns int32 [F, W]. Same semantics as
    ``ref.refine_bitmap_rows_hier_ref``. ``dma_depth`` is accepted for
    parity with the reference (its chunk-copy pipeline depth); the CUDA
    kernel does not read it and it changes no bit. ``backend`` names
    this call's backend (``config.backend_for``). The CUDA kernel reads a
    strided input from a contiguous copy. A ``DTensor`` argument raises
    ``TypeError``.
    """
    _no_dtensor(summary=summary, chunk_ptr=chunk_ptr, chunk_id=chunk_id,
                chunk_data=chunk_data, cand_rows=cand_rows,
                frontier=frontier, active=active)
    if dma_depth is not None and int(dma_depth) < 1:
        raise ValueError(f"dma_depth must be >= 1, got {dma_depth!r}")
    if backend_for(cand_rows, backend) == "torch":
        return refine_bitmap_rows_hier_ref(summary, chunk_ptr, chunk_id,
                                           chunk_data, kmax, cand_rows,
                                           frontier, active)
    global HIER_LAUNCHES
    dev = cand_rows.device
    (summary, chunk_ptr, chunk_id, chunk_data, cand_rows, frontier,
     active) = (_checked(name, t, dev, nd) for name, t, nd in (
         ("summary", summary, 2), ("chunk_ptr", chunk_ptr, 1),
         ("chunk_id", chunk_id, 1), ("chunk_data", chunk_data, 2),
         ("cand_rows", cand_rows, 2), ("frontier", frontier, 2),
         ("active", active, 2)))
    v, sw = summary.shape
    n_store, c = chunk_data.shape
    f, np_ = frontier.shape
    w = cand_rows.shape[1]
    if (chunk_ptr.shape[0] != v + 1 or chunk_id.shape[0] != n_store
            or cand_rows.shape[0] != f or active.shape != (f, np_)):
        raise ValueError("shape mismatch: summary [V, SW], chunk_ptr "
                         "[V + 1], chunk_id [P], chunk_data [P, C], cand "
                         "[F, W], frontier/active [F, NP]")
    if np_ > MAX_POSITIONS or v < 1:
        raise ValueError(f"need 1 <= V and NP <= {MAX_POSITIONS}")
    if c < 1 or c > 128 or c & (c - 1):
        raise ValueError(f"chunk width {c} is not a power of two in "
                         "[1, 128]")
    if sw * 32 * c < w:
        raise ValueError(f"{sw} summary words of {c}-word chunks cover "
                         f"fewer than W = {w} words")
    out = torch.empty_like(cand_rows)
    if f == 0 or w == 0:
        return out
    lib = _library("refine_bitmap_rows_hier")
    smem = hier_smem_bytes(w, sw)
    if smem > 48 * 1024:
        limit = hier_max_smem()
        if smem > limit:
            raise ValueError(
                f"refine_bitmap_rows_hier keeps a row of W = {w} words and "
                f"its summary in shared memory ({smem} bytes); this card "
                f"allows {limit}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.refine_bitmap_rows_hier_launch(
        summary.data_ptr(), chunk_ptr.data_ptr(), chunk_id.data_ptr(),
        chunk_data.data_ptr(), cand_rows.data_ptr(), frontier.data_ptr(),
        active.data_ptr(), out.data_ptr(), v, sw, c, w, f, np_, stream)
    if err != 0:
        raise RuntimeError(f"refine_bitmap_rows_hier launch failed: CUDA "
                           f"error {err}")
    HIER_LAUNCHES += 1
    return out
