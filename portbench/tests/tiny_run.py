"""Runs the tiny cell on the host CPU in a fresh interpreter, once per
named scenario, and prints ``{scenario: [exit code, result]}`` as JSON.

    python -m portbench.tests.tiny_run <checkout root> <scenario>...

Scenarios: ``ok``; ``stall`` (``step()`` returns with nothing done);
``half`` (each answer keeps half its embeddings and says so);
``alter`` (one vertex of each answer's first embedding changed where
the answer is produced); ``guard`` (a module named ``repro`` appears in
``sys.modules`` during the run). A fresh interpreter is needed because
a test process may hold JAX and the JAX package already.
"""
from __future__ import annotations

import json
import sys
import time
import types

import numpy as np


def stall(server):
    server.step = lambda: True


def _wrap_finish(server, change):
    orig = server.session._finish_handle

    def finish(h, embeddings, stats, latency_s):
        embeddings, stats = change(list(embeddings), stats)
        orig(h, embeddings, stats, latency_s)

    server.session._finish_handle = finish


def half(server):
    def change(emb, stats):
        keep = emb[:len(emb) // 2]
        stats.found = len(keep)
        return keep, stats
    _wrap_finish(server, change)


def alter(server):
    n = server.data.n

    def change(emb, stats):
        if emb:
            e = np.array(emb[0], copy=True)
            e[0] = (int(e[0]) + 1) % n
            emb[0] = e
        return emb, stats
    _wrap_finish(server, change)


def guard(server):
    sys.modules["repro"] = types.ModuleType("repro")


FAULTS = {"ok": None, "stall": stall, "half": half, "alter": alter,
          "guard": guard}


def main(argv):
    from pathlib import Path

    import torch
    torch.set_num_threads(1)
    from portbench import harness
    root = Path(argv[0])
    out = {}
    for name in argv[1:]:
        args = harness.parse(["--workload", "tiny-t5", "--seed",
                              "3000000019", "--seconds", "2", "--trace",
                              "0"])
        code, result = harness.run(args, time.perf_counter(), device="cpu",
                                   root=root, fault=FAULTS[name])
        sys.modules.pop("repro", None)
        out[name] = [code, result]
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
