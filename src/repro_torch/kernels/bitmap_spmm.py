"""Packed-bitmap SpMM: wrapper and launch count.

:func:`bitmap_spmm` is the port of the reference's Pallas kernel of the
same name (``repro/kernels/bitmap_spmm.py``): ``A @ x`` for a 0/1 matrix
given as packed words. For a CUDA tensor it launches the hand-written
kernel ``csrc/bitmap_spmm.cu`` (built and loaded by ``build.py``); for a
CPU tensor it runs the plain ``ref.bitmap_spmm_ref``. A CUDA call either
launches or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .config import backend_for
from .ref import bitmap_spmm_ref

SPMM_LAUNCHES = 0       # kernel launches made by bitmap_spmm

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"bitmap_spmm_launch": ([_P] * 3 + [_I] * 4 + [_P], _I)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    return build.load("bitmap_spmm", SIGNATURES)


def bitmap_spmm(adj_words: torch.Tensor, x: torch.Tensor,
                block_i: int | None = None,
                block_j: int | None = None,
                backend: str | None = None) -> torch.Tensor:
    """``A @ x`` for the 0/1 matrix A [N, 32 W] packed in ``adj_words``
    (int32 [N, W], the bit patterns of the reference's uint32 words;
    padding bits of the last word must be zero). ``x`` f32 or bf16
    [32 W, D]. Returns [N, D] in ``x.dtype``, summed in f32 (the CUDA
    kernel carries each sum's rounding error, so both paths give the
    exact sum to within a few f32 units).

    ``block_i`` / ``block_j`` are accepted for parity with the reference
    (its output-row and contraction tiles); the CUDA kernel does not read
    them and they change no bit. ``backend`` names this call's backend
    (``config.backend_for``).
    """
    if adj_words.dim() != 2 or x.dim() != 2:
        raise ValueError(f"need adj_words [N, W] and x [32 W, D], got "
                         f"{tuple(adj_words.shape)}, {tuple(x.shape)}")
    n, w = adj_words.shape
    m, d = x.shape
    if m != 32 * w:
        raise ValueError(f"x has {m} rows, not 32 W = {32 * w}")
    if backend_for(x, backend) == "torch":
        return bitmap_spmm_ref(adj_words, x)
    global SPMM_LAUNCHES
    dev = x.device
    for name, t in (("adj_words", adj_words), ("x", x)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if adj_words.dtype != torch.int32:
        raise TypeError(f"adj_words must be int32, got {adj_words.dtype}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    out = torch.empty((n, d), dtype=x.dtype, device=dev)
    if n == 0 or d == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().bitmap_spmm_launch(
        adj_words.data_ptr(), x.data_ptr(), out.data_ptr(), n, w, d,
        DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"bitmap_spmm launch failed: CUDA error {err}")
    SPMM_LAUNCHES += 1
    return out
