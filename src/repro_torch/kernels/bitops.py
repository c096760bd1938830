"""Bit operations on int32 words.

Packed bitmaps and masks are carried as int32 tensors (the same bit
patterns the reference keeps in uint32): torch has no usable uint32
arithmetic. Where the reference relies on uint32 semantics — logical
shifts, wraparound multiplies, unsigned compares — the work is done on
the unsigned value held in int64 (``u32``) and wrapped back with
``to_i32``, so no step depends on signed overflow.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its unsigned value, as int64."""
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor -> the int32 with that pattern."""
    return (((x & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """``(a * m) mod 2**32`` for unsigned ``a`` (int64) and a 32-bit
    constant ``m``, split in 16-bit halves so no product leaves int64."""
    lo = a * (m & 0xFFFF)
    hi = (a * (m >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def bit_table(device) -> torch.Tensor:
    """int32 [32]: the word with only bit i set (bit 31 is INT_MIN)."""
    return to_i32(torch.ones(32, dtype=torch.int64, device=device)
                  << torch.arange(32, device=device))


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits per int32 word (SWAR on the unsigned value) -> int32."""
    v = u32(x)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & MASK32) >> 24).to(torch.int32)


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """Sum of set bits over the last axis -> int32 [...]."""
    return popcount(words).sum(dim=-1, dtype=torch.int32)


def lshr(x: torch.Tensor, k) -> torch.Tensor:
    """Logical right shift of int32 words by ``k`` (int or tensor in
    [0, 31]): arithmetic ``>>`` on the unsigned value."""
    return to_i32(u32(x) >> k)


def lowest_bit(x: torch.Tensor) -> torch.Tensor:
    """``x & -x`` on int32 words: the lowest set bit (0 for 0). Done in
    int64 — ``-x`` overflows int32 when only bit 31 is set."""
    v = u32(x)
    return to_i32(v & (-v))


def bit_index(lsb: torch.Tensor) -> torch.Tensor:
    """Index of a single set bit (``popcount(lsb - 1)``); 32 for 0."""
    return popcount(to_i32(u32(lsb) - 1))


def bitlen32(x: torch.Tensor) -> torch.Tensor:
    """Highest set bit + 1 of an int32 word (0 for 0), bit-smear +
    popcount as in the reference."""
    v = u32(x)
    for s in (1, 2, 4, 8, 16):
        v = v | (v >> s)
    return popcount(to_i32(v))
