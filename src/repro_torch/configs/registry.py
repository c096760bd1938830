"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from . import (deepseek_v3_671b, din, gcn_cora, gin_tu, kimi_k2_1t, mace,
               nequip, paper_matcher, qwen2_5_14b, qwen3_0_6b,
               starcoder2_15b)
from .common import ArchSpec

_MODULES = (qwen2_5_14b, qwen3_0_6b, starcoder2_15b, deepseek_v3_671b,
            kimi_k2_1t, gcn_cora, nequip, mace, gin_tu, din,
            paper_matcher)

ARCHS: dict[str, ArchSpec] = {m.spec().arch_id: m.spec() for m in _MODULES}

ASSIGNED = [a for a in ARCHS if a != "paper-matcher"]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells(include_matcher: bool = False) -> list[tuple[str, str]]:
    """Every (arch, shape) dry-run cell."""
    out = []
    for aid, spec in ARCHS.items():
        if aid == "paper-matcher" and not include_matcher:
            continue
        out += [(aid, c.name) for c in spec.shapes]
    return out
