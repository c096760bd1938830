"""Packed-bitmap SpMM: wrapper, route plan and launch counts.

:func:`bitmap_spmm` is the port of the reference's Pallas kernel of the
same name (``repro/kernels/bitmap_spmm.py``): ``A @ x`` for a 0/1 matrix
given as packed words. For a CPU tensor it runs the plain
``ref.bitmap_spmm_ref``. For a CUDA tensor it launches one of three
hand-written kernels (routes) of ``csrc/bitmap_spmm.cu`` (built and
loaded by ``build.py``), picked by :func:`plan` from the shape alone:

* ``split`` — D up to 128 (one warp holds a row's columns): each row's
  set-bit list is cut into one slice per warp of its block
  (``SPLIT_WARPS``, fixed in the kernel), so a hub row's x loads run on
  every warp at once, and the partial sums are combined in warp order;
* ``stream`` — D up to 128 on rows of more than ``LONG_ROW_WORDS``
  words, where reading the row takes the time: a warp per row streams it
  through a ring of ``cp.async`` copies in shared memory, several passes
  in flight;
* ``wide`` — wider D: a block of 128 threads per 512-column tile walks
  the row's set bits, each thread on 4 of the tile's columns.

A CUDA call either launches its route's kernel or raises; nothing falls
back to another route or to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .config import backend_for
from .ref import bitmap_spmm_ref

SPMM_LAUNCHES = 0                       # kernel launches made by bitmap_spmm
SPMM_ROUTES = {"split": 0, "stream": 0, "wide": 0}   # the same, by route
SPLIT_MAX_COLS = 128    # split and stream: the columns one warp holds
SPLIT_WARPS = 4         # split: warps per row, the kernel's kSplitWarps
LONG_ROW_WORDS = 512    # longer rows take the stream route

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {f"bitmap_spmm_{route}_launch": ([_P] * 3 + [_I] * 4 + [_P], _I)
              for route in SPMM_ROUTES}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plan(words_shape, x_shape, dtype: torch.dtype) -> str:
    """The route of a CUDA call on words ``[N, W]`` and x ``[32 W, D]``
    in ``dtype``: for ``D <= SPLIT_MAX_COLS``, ``stream`` on rows of more
    than ``LONG_ROW_WORDS`` words (a row of the 65536-vertex graph is
    2048 words with ~6 set bits: reading it takes the time) and ``split``
    on shorter ones; ``wide`` for wider D. Raises for a dtype the kernels
    do not take.

    The cut is where the two routes crossed on square power-law graphs
    of mean degree 6 and 36 on an H100 (``scripts/spmm_sweep.py``):
    ``split`` faster up to 384 and 512 words, ``stream`` from 512 and
    768.
    """
    if dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    if x_shape[1] > SPLIT_MAX_COLS:
        return "wide"
    return "stream" if words_shape[1] > LONG_ROW_WORDS else "split"


def row_slices(route: str) -> int:
    """The slices each row's set-bit list is cut into on ``route``: the
    ``groups`` of ``ref.bitmap_spmm_split_ref`` that reproduces it."""
    return SPLIT_WARPS if route == "split" else 1


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
    return _launch(adj_words, x, plan(adj_words.shape, x.shape, x.dtype))


def _launch(adj_words: torch.Tensor, x: torch.Tensor, route: str
            ) -> torch.Tensor:
    """One launch of the CUDA kernel on ``route`` (:func:`bitmap_spmm`
    passes :func:`plan`'s), on card tensors of the shapes it checked
    (strided ones read from contiguous copies); counts it."""
    global SPMM_LAUNCHES
    dev = x.device
    if adj_words.device != dev:
        raise ValueError(f"adj_words on {adj_words.device}, expected {dev}")
    if adj_words.dtype != torch.int32:
        raise TypeError(f"adj_words must be int32, got {adj_words.dtype}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    adj_words, x = adj_words.contiguous(), x.contiguous()
    n, w = adj_words.shape
    d = x.shape[1]
    out = torch.empty((n, d), dtype=x.dtype, device=dev)
    if n == 0 or d == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (adj_words.data_ptr(), x.data_ptr(), out.data_ptr())
    launch = getattr(_library(), f"bitmap_spmm_{route}_launch")
    err = launch(*ptrs, n, w, d, DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"bitmap_spmm {route} launch failed: CUDA "
                           f"error {err}")
    SPMM_LAUNCHES += 1
    SPMM_ROUTES[route] += 1
    return out
