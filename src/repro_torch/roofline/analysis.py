"""Roofline terms of a dry-run cell (twin of ``repro.roofline.analysis``).

Three terms per (arch x shape x mesh), in seconds, each from this
rank's counts (``hlo_cost.count_run``):

    compute    = FLOPs / peak_FLOPs
    memory     = bytes / HBM_bw
    collective = collective_bytes / link_bw

The constants are one NVIDIA H100 SXM5's (H100 80GB HBM3 at its 700 W
limit), from NVIDIA's H100 Tensor Core GPU data sheet: dense bf16 tensor
rate without sparsity, HBM3 bandwidth, and NVLink 4 bandwidth per
direction (900 GB/s total, 450 GB/s each way). They are spec figures:
a card set below 700 W runs slower. The reference's HLO-text parsers
(``collective_bytes``, ``_shape_bytes``) have no twin: the port counts
ops as they run, not a compiled program.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM5 (NVIDIA data sheet)
HBM_BW = 3.35e12             # bytes/s, HBM3, H100 SXM5 (same)
LINK_BW = 450e9              # bytes/s, NVLink 4, one direction (same)
HBM_BYTES = 80e9             # bytes of HBM3 on one card (same)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_counts: dict
    model_flops: float | None = None
    mem_per_device: float | None = None
    # bytes in and out of the port's own kernel ops (the reference's
    # Pallas custom-calls); none runs on a dry-run's path
    custom_call_bytes: float = 0.0
    custom_call_count: int = 0

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def useful_flops_frac(self) -> float | None:
        if not self.model_flops or not self.hlo_flops:
            return None
        return self.model_flops / (self.hlo_flops * self.chips)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_device": self.hlo_flops,
            "hlo_bytes_per_device": self.hlo_bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "coll_counts": self.coll_counts,
            "custom_call_bytes_per_device": self.custom_call_bytes,
            "custom_call_count": self.custom_call_count,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "mem_per_device_bytes": self.mem_per_device,
        }


def analyze(arch: str, shape: str, mesh_name: str, chips: int, cost,
            model_flops: float | None = None) -> Roofline:
    """The roofline of one cell from its count (an ``HloCost``).
    ``coll_counts`` holds the bytes of each collective kind, as the
    reference's does, plus ``count`` (collectives issued, from
    ``CommDebugMode``), ``unresolved_loops`` (0: an eager run leaves no
    loop to resolve) and ``xla_flops_ref`` (None: no XLA here)."""
    coll = {k: float(v) for k, v in cost.coll_by_kind.items()}
    coll.update(count=cost.coll_count,
                unresolved_loops=cost.unresolved_loops, xla_flops_ref=None)
    return Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                    hlo_flops=float(cost.flops), hlo_bytes=float(cost.bytes),
                    coll_bytes=float(cost.coll_bytes), coll_counts=coll,
                    model_flops=model_flops,
                    mem_per_device=float(cost.peak_bytes) or None,
                    custom_call_bytes=float(cost.custom_call_bytes),
                    custom_call_count=int(cost.custom_call_count))
