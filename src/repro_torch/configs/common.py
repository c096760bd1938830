"""Architecture spec plumbing shared by all config files.

Each ``configs/<arch>.py`` exposes ``spec() -> ArchSpec`` with
  * ``config``  — the exact published configuration (full scale),
  * ``shapes``  — the arch's assigned input-shape cells,
  * ``smoke_config`` — a reduced same-family config for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # train | prefill | decode | full_graph |
    #                      sampled | batched_graphs | recsys_train |
    #                      recsys_serve | recsys_retrieval
    dims: dict[str, int]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str          # "lm" | "gnn" | "equiv" | "recsys"
    config: Any
    smoke_config: Any
    shapes: tuple[ShapeCell, ...]
    notes: str = ""

    def shape(self, name: str) -> ShapeCell:
        for c in self.shapes:
            if c.name == name:
                return c
        raise KeyError(f"{self.arch_id} has no shape {name!r}: "
                       f"{[c.name for c in self.shapes]}")


def lm_shapes() -> tuple[ShapeCell, ...]:
    return (
        ShapeCell("train_4k", "train",
                  dict(seq_len=4096, global_batch=256)),
        ShapeCell("prefill_32k", "prefill",
                  dict(seq_len=32768, global_batch=32)),
        ShapeCell("decode_32k", "decode",
                  dict(kv_len=32768, global_batch=128)),
        ShapeCell("long_500k", "decode",
                  dict(kv_len=524288, global_batch=1)),
    )


def gnn_shapes() -> tuple[ShapeCell, ...]:
    return (
        ShapeCell("full_graph_sm", "full_graph",
                  dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                       n_classes=7)),
        ShapeCell("minibatch_lg", "sampled",
                  dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                       fanout0=15, fanout1=10, d_feat=602, n_classes=41)),
        ShapeCell("ogb_products", "full_graph",
                  dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                       n_classes=47)),
        ShapeCell("molecule", "batched_graphs",
                  dict(n_nodes=30, n_edges=64, batch=128, n_species=10)),
    )


def recsys_shapes() -> tuple[ShapeCell, ...]:
    return (
        ShapeCell("train_batch", "recsys_train", dict(batch=65536)),
        ShapeCell("serve_p99", "recsys_serve", dict(batch=512)),
        ShapeCell("serve_bulk", "recsys_serve", dict(batch=262144)),
        ShapeCell("retrieval_cand", "recsys_retrieval",
                  dict(batch=1, n_candidates=1000000)),
    )
