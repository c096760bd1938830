"""A tiny cell for the CPU tests: a checkout root of its own in a
temporary directory, holding ``BENCHMARK.json`` with one cell, its
configuration and traffic files, and the real metric readers
(copied), so a whole run fits in seconds on the host."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # portbench/
REPO = HERE.parent

CONFIG = {
    "name": "tiny",
    "source": "test",
    "graph": {"generator": "attachment_graph", "seed": 3,
              "params": {"n_vertices": 300, "n_edges": 1500,
                         "n_labels": 6, "attach": 3}},
    "engine": {"n_slots": 4, "wave_size": 64, "kpr": 4,
               "pattern_capacity": 1024, "stack_capacity": 256,
               "megastep_depth": 4},
    "limit": 50,
}

TRAFFIC = {"name": "t5", "loop": "closed", "clients": 4,
           "query_vertices": 5, "pool": 400, "control_queries": 60,
           "warmup_max_s": 3, "drain_max_s": 3, "profile_s": 1}


def make_root(tmp: Path, per_layer=None) -> Path:
    root = Path(tmp) / "checkout"
    pb = root / "portbench"
    (pb / "configs").mkdir(parents=True)
    (pb / "traffic").mkdir()
    shutil.copytree(HERE / "metrics", pb / "metrics")
    (pb / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (pb / "traffic" / "t5.json").write_text(json.dumps(TRAFFIC))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny-t5", "config": "tiny",
                           "traffic": "t5", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    if per_layer is not None:
        bench["per_layer"] = [m for m in bench["per_layer"]
                              if m["name"] in per_layer]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
