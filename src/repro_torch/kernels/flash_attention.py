"""Fused attention forward: wrapper and launch count.

:func:`flash_attention` is the port of the reference's Pallas kernel of
the same name (``repro/kernels/flash_attention.py``). For a CUDA tensor
it launches the hand-written kernel ``csrc/flash_attention.cu`` (built
and loaded by ``build.py``); for a CPU tensor it runs the plain
``ref.flash_attention_ref``. A CUDA call either launches or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .config import backend_for
from .ref import flash_attention_ref

FLASH_LAUNCHES = 0      # kernel launches made by flash_attention
MAX_HEAD_DIM = 256      # every head size in the reference's configs

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"flash_attention_launch": (
    [_P] * 4 + [_I] * 5 + [ctypes.c_float, _I, _I, _P], _I)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    as the reference asserts; the CUDA kernel picks its own tiles. The
    kernel takes ``D <= 256`` and raises past it. ``backend`` names this
    call's backend (``config.backend_for``).
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
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPES:
        raise TypeError(f"need float32 or bfloat16, got {q.dtype}")
    b, h, s, d = q.shape
    h_kv, s_kv = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head size {d} > {MAX_HEAD_DIM}: the CUDA "
                         "kernel does not take it")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
        h // h_kv, s, s_kv, d, d ** -0.5, int(causal), DTYPES[q.dtype],
        stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err}")
    FLASH_LAUNCHES += 1
    return out
