"""Fused attention forward: wrapper, route plan and launch counts.

:func:`flash_attention` is the port of the reference's Pallas kernel of
the same name (``repro/kernels/flash_attention.py``). For a CPU tensor
it runs the plain ``ref.flash_attention_ref``. For a CUDA tensor it
launches one of three hand-written kernels of
``csrc/flash_attention.cu`` (built and loaded by ``build.py``), picked by
:func:`plan` from shape and dtype alone:

* ``split`` — decode-shaped calls (``group * S <= 64`` query rows per kv
  head, rows 16-byte aligned), f32 or bf16: split-K over the keys, one
  block per (b, kv head, key split) holding every query row that reads
  that kv head, then a combine pass;
* ``tc`` — the rest in bf16 with D a multiple of 16: ``wgmma`` on the
  tensor cores, P rounded to bf16 before P·V;
* ``fma`` — everything else (f32 prefill, bf16 with D not a multiple of
  16): the FMA kernel, exact f32 arithmetic.

A CUDA call either launches its route's kernel or raises; nothing falls
back to another route or to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import build
from .config import backend_for
from .ref import flash_attention_ref

FLASH_LAUNCHES = 0      # op calls that launched a kernel
FLASH_ROUTES = {"split": 0, "tc": 0, "fma": 0}   # the same, by route
MAX_HEAD_DIM = 256      # every head size in the reference's configs
SPLIT_MAX_ROWS = 64     # split route: most query rows per kv head
SPLIT_MIN_KEYS = 256    # key splits: a power of two of at least this many
SPLIT_BLOCKS_PER_SM = 4  # and as short as keeps the grid within this many
                         # blocks per SM (one resident wave)
TC_D_STEP = 16          # tc route: D a multiple of the wgmma depth

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "flash_attention_launch": (
        [_P] * 4 + [_I] * 5 + [ctypes.c_float, _I, _I, _P], _I),
    "flash_split_launch": (
        [_P] * 6 + [_I] * 7 + [ctypes.c_float, _I, _I, _P], _I),
    "flash_tc_launch": (
        [_P] * 4 + [_I] * 5 + [ctypes.c_float, _I, _P], _I)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class FlashPlan:
    """A CUDA call's route; for ``split`` also its key splits (the last
    one may be short) and the query rows per kv head."""
    route: str
    n_splits: int = 1
    split_len: int = 0
    rows: int = 0


def plan(q_shape, kv_shape, dtype: torch.dtype, n_sm: int = 132
         ) -> FlashPlan:
    """The route of a CUDA call on q ``[B, H, S, D]`` against k / v
    ``[B, Hkv, Skv, D]`` in ``dtype``, on a card of ``n_sm`` SMs.

    ``split`` takes calls of at most ``SPLIT_MAX_ROWS`` query rows per kv
    head whose rows are whole 16-byte words. Its key splits are a power
    of two of at least ``SPLIT_MIN_KEYS`` keys (so a multiple of every
    key tile of the kernel), the shortest that keeps the grid of one
    block per (b, kv head, split) within ``SPLIT_BLOCKS_PER_SM * n_sm``
    blocks: all of them resident at once (four fit on an SM), between two
    and four per SM on a long cache. ``tc`` takes the rest in bf16 with D
    a multiple of ``TC_D_STEP``; ``fma`` the rest. Raises for a dtype or
    head size that no route takes.
    """
    b, h, s, d = q_shape
    h_kv, s_kv = kv_shape[1], kv_shape[2]
    if dtype not in DTYPES:
        raise TypeError(f"need float32 or bfloat16, got {dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head size {d} > {MAX_HEAD_DIM}: no CUDA route "
                         "takes it")
    rows = (h // h_kv) * s
    per_word = 16 // (4 if dtype == torch.float32 else 2)
    if rows <= SPLIT_MAX_ROWS and d % per_word == 0:
        split = SPLIT_MIN_KEYS
        while (split < s_kv and b * h_kv * -(-s_kv // split)
               > SPLIT_BLOCKS_PER_SM * n_sm):
            split *= 2
        return FlashPlan("split", -(-s_kv // split), split, rows)
    if dtype == torch.bfloat16 and d % TC_D_STEP == 0:
        return FlashPlan("tc")
    return FlashPlan("fma")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library() -> ctypes.CDLL:
    return build.load("flash_attention", SIGNATURES)


def _check_shapes(q, k, v, block_q: int, block_k: int) -> None:
    """The reference wrapper's asserts, as errors, on every backend."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("need q [B, H, S, D] and k, v [B, Hkv, Skv, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    bk_, h_kv, s_kv, dk = k.shape
    if bk_ != b or dk != d or h_kv < 1 or h % h_kv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (Hkv must divide H)")
    bq, bk = min(block_q, s), min(block_k, s_kv)
    if bq < 1 or bk < 1 or s % bq or s_kv % bk:
        raise ValueError(f"blocks ({block_q}, {block_k}) do not divide "
                         f"S = {s}, Skv = {s_kv}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128,
                    backend: str | None = None) -> torch.Tensor:
    """Attention forward, [B, H, S, D] queries against [B, Hkv, Skv, D]
    keys and values (Hkv divides H; query head h reads kv head
    ``h // (H // Hkv)``), f32 or bf16. Returns q's dtype; softmax state
    and accumulator are f32, ``scale = D ** -0.5``. The causal mask is
    top-left aligned: key j is visible to query i iff ``j <= i``.

    ``block_q`` / ``block_k`` must divide S / Skv once capped at them,
    as the reference asserts; the CUDA kernels pick their own tiles.
    The route comes from :func:`plan`; the kernels take ``D <= 256`` in
    f32 or bf16 and raise past that. They read a strided input from a
    contiguous copy. ``backend`` names this call's backend
    (``config.backend_for``).
    """
    _check_shapes(q, k, v, block_q, block_k)
    if backend_for(q, backend) == "torch":
        return flash_attention_ref(q, k, v, causal=causal)
    global FLASH_LAUNCHES
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    route = plan(q.shape, k.shape, q.dtype, _sm_count(dev.index or 0))
    b, h, s, d = q.shape
    h_kv, s_kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if route.route == "split":
        parts = b * h_kv * route.n_splits * route.rows
        ml = torch.empty(2 * parts, dtype=torch.float32, device=dev)
        acc = torch.empty((parts, d), dtype=torch.float32, device=dev)
        err = lib.flash_split_launch(
            *ptrs, ml.data_ptr(), acc.data_ptr(), b * h_kv, route.rows, s,
            s_kv, d, route.n_splits, route.split_len, d ** -0.5,
            int(causal), DTYPES[q.dtype], stream)
    elif route.route == "tc":
        err = lib.flash_tc_launch(*ptrs, b * h, h // h_kv, s, s_kv, d,
                                  d ** -0.5, int(causal), stream)
    else:
        err = lib.flash_attention_launch(
            *ptrs, b * h, h // h_kv, s, s_kv, d, d ** -0.5, int(causal),
            DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {route.route} launch failed: "
                           f"CUDA error {err}")
    FLASH_LAUNCHES += 1
    FLASH_ROUTES[route.route] += 1
    return out
