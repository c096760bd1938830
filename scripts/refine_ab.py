#!/usr/bin/env python3
"""Both refine kernels against another version of their sources, in
turns, on the main path's captured inputs, on one GPU.

    python3 scripts/refine_ab.py OTHER_DIR

``OTHER_DIR`` is a checkout of another commit (for example the parent,
unpacked with ``git archive`` into a directory that ``.gitignore``
lists). Its ``src/repro_torch/kernels/csrc/bitmap_refine.cu`` and
``bitmap_refine_hier.cu`` are built beside this tree's, with the same
``nvcc`` flags and ``-Xptxas -v``; the C interface must be this tree's.

1. The refine inputs are captured as ``chip_smoke.py`` captures them:
   the human-like workload (dense kernel) and the scale workload (hier
   kernel) served once through the port, a seeded sample of 128 calls
   of each kept.
2. Every captured call of both versions equals the plain version bit
   for bit.
3. Each kernel is timed by CUDA-graph replay (``chip_smoke.device_ms``:
   all dense samples, the hier kernel's first 32) in the order other,
   this, this, other, between two timings of the launch floor (a
   one-element ``zero_()``, ``chip_smoke.launch_floor_ms``).

Prints the card's name and power limit, both builds' ptxas lines and
one JSON line of times (ms per call). Exits non-zero without a card or
on a failed check.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

NAMES = ("refine_bitmap_rows", "refine_bitmap_rows_hier")


def ptxas_lines(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def build_other(other: Path) -> dict:
    """This tree's kernel sources' names, built from ``other``'s csrc
    into ``build/repro_torch/other/``, one nvcc each, together. Returns
    ``{name: (library path, compiler output)}``."""
    from repro_torch.kernels import build
    csrc = other / "src" / "repro_torch" / "kernels" / "csrc"
    dest = build.BUILD_DIR / "other"
    dest.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in NAMES:
        src = csrc / build.SOURCES[name].name
        lib = dest / f"lib{src.stem}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(lib), str(src)]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), lib)
    out = {}
    for name, (proc, lib) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} of {other}:\n{log}")
        out[name] = (lib, log)
    return out


def load(name: str, path: Path) -> ctypes.CDLL:
    from repro_torch.kernels.bitmap_refine import SIGNATURES
    lib = ctypes.CDLL(str(path))
    for symbol, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("refine_ab: needs a CUDA device and OTHER_DIR",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import bitmap_refine as br
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import (refine_bitmap_rows_hier_ref,
                                         refine_bitmap_rows_ref)
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    other = build_other(Path(sys.argv[1]).resolve())
    this = build.build_all(NAMES, verbose=True)
    for name in NAMES:
        print(json.dumps({"kernel": name,
                          "this_ptxas": ptxas_lines(this[name][2]),
                          "other_ptxas": ptxas_lines(other[name][1])}),
              flush=True)
    libs = {"this": {n: br._library(n) for n in NAMES},
            "other": {n: load(n, other[n][0]) for n in NAMES}}

    wl = cs.workloads()
    cs.warm_up(dev, wl)
    dense: list = []
    hier: list = []
    cs.serve(dev, {k: wl[k] for k in ("human", "scale")}, capture={
        "human": ("refine_bitmap_rows", cs.sampler(dense, 3)),
        "scale": ("refine_bitmap_rows_hier", cs.sampler(hier, 3))})
    cases = {"refine_bitmap_rows": (br.refine_bitmap_rows,
                                    refine_bitmap_rows_ref, dense),
             "refine_bitmap_rows_hier": (br.refine_bitmap_rows_hier,
                                         refine_bitmap_rows_hier_ref,
                                         hier)}
    for version, by_name in libs.items():
        build._libs.update(by_name)
        for name, (kernel, plain, samples) in cases.items():
            for s in samples:
                cs.require(torch.equal(kernel(*s), plain(*s)),
                           f"{version} {name} != plain on a captured input")
    result = {"floor_ms": [cs.launch_floor_ms(dev)]}
    for name, (kernel, _, samples) in cases.items():
        timed = samples if name == "refine_bitmap_rows" else \
            samples[:cs.N_TIMED_HIER]
        runs = []
        for version in ("other", "this", "this", "other"):
            build._libs[name] = libs[version][name]
            runs.append((version, cs.device_ms(kernel, timed)))
        build._libs[name] = libs["this"][name]
        result[name] = {"order": [v for v, _ in runs],
                        "ms": [t for _, t in runs], "samples": len(timed),
                        "this_ms": (runs[1][1] + runs[2][1]) / 2,
                        "other_ms": (runs[0][1] + runs[3][1]) / 2}
    result["floor_ms"].append(cs.launch_floor_ms(dev))
    floor = sum(result["floor_ms"]) / 2
    for name in NAMES:
        r = result[name]
        r["this_over_other"] = r["this_ms"] / r["other_ms"]
        r["above_floor_ratio"] = ((r["this_ms"] - floor)
                                  / (r["other_ms"] - floor))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError as exc:       # SmokeFailure and nvcc failures
        print(f"refine_ab: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
