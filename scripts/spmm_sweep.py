#!/usr/bin/env python3
"""The SpMM kernel's routes, on the op layer's cases and across row
widths, on one GPU.

    python3 scripts/spmm_sweep.py

1. Routes. For each of ``chip_smoke.py``'s SpMM cases (a) human-like,
   (b) Cora-shaped and (c) scale, in f32 and bf16, every route
   (``split``, ``stream``, ``wide``) is launched, held against the plain
   version (rtol / atol 1e-5 in f32, 2e-2 in bf16) and, bit for bit,
   against ``ref.bitmap_spmm_split_ref`` (the CPU emulation of its
   decomposition, run on the card), and timed (CUDA-graph replay)
   beside the bound, the bytes the gathers move through L2
   (nnz * D * element size) and ``torch.sparse.mm``'s time.
2. The cut between ``split`` and ``stream`` (``LONG_ROW_WORDS``). At D
   128, rows of ``WIDTHS`` words from three families: power-law graphs
   of 32 W vertices with mean degree 6 (``m_attach`` 3, the scale
   graph's family) and 36 (``m_attach`` 18, the human-like graph's
   mean degree), and the human-like adjacency padded with zero words
   (its hub rows, up to 408 set bits, on longer rows; not square);
   ``split`` and ``stream`` are each held against the plain version and
   timed beside ``torch.sparse.mm``.

Prints the card's name and power limit, the kernel's ptxas lines and one
JSON line per (case, route) and per (family, width, type). Exits
non-zero without a card or on a failed check (``chip_smoke.close_err``
stops the script at the first output out of tolerance).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

WIDTHS = (147, 256, 384, 512, 768, 1024, 1536, 2048)
ROUTES = ("split", "stream", "wide")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("spmm_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.data.graph_gen import human_like_graph, powerlaw_graph
    from repro_torch.kernels import bitmap_spmm as bs
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import bitmap_spmm_ref, bitmap_spmm_split_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    _, secs, log = build.build_all(["bitmap_spmm"], verbose=True)[
        "bitmap_spmm"]
    print(json.dumps({"build_s": secs, "ptxas": [
        ln.strip() for ln in log.splitlines()
        if "entry function" in ln or "registers" in ln or "spill" in ln]}),
        flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def tol_of(x):
        return 1e-5 if x.dtype == torch.float32 else 2e-2

    human = human_like_graph(seed=0)
    scale = powerlaw_graph(65536, 3, 16, seed=0)
    ok = True
    spmm = cs.spmm_cases(dev, {"human": (human,), "scale": (scale,)}, randn)
    for name, planned in cs.SPMM_TIMED.items():
        words, x = spmm[name]
        tol = tol_of(x)
        want = bitmap_spmm_ref(words, x)
        csr = cs.spmm_csr(words, x.dtype)
        t_bytes, t_ops, counts = cs.spmm_bound(words, x, csr)
        lib = cs.library_ms(torch.sparse.mm, (csr, x))
        del csr
        gathered = counts["nnz"] * x.shape[1] * x.element_size()
        for route in ROUTES:
            got = bs._launch(words, x, route)
            err = cs.close_err(got, want, tol, max(tol, 1e-5))
            emu = bitmap_spmm_split_ref(words, x,
                                        groups=bs.row_slices(route))
            same = bool(torch.equal(got, emu))
            del got, emu
            torch.cuda.empty_cache()
            ms = cs.device_ms(lambda w_, x_, r=route: bs._launch(w_, x_, r),
                              [(words, x)])
            print(json.dumps({
                "case": name, "route": route, "planned": route == planned,
                "ms": ms, "library_ms": lib, "bound_ms": max(t_bytes, t_ops),
                "share_of_bound": max(t_bytes, t_ops) / ms,
                "gathered_bytes": gathered,
                "gathered_GBps": gathered / ms / 1e6,
                "max_abs_err": err, "equals_emulation": same, **counts}),
                flush=True)
            if not same:
                print(f"spmm_sweep: {name} on {route} differs from its "
                      "emulation", file=sys.stderr)
                ok = False
        del want
        torch.cuda.empty_cache()

    human_words = torch.from_numpy(human.adj_bitmap.view("int32")).to(dev)
    for w in WIDTHS:
        pad = torch.zeros((human_words.shape[0], w - human_words.shape[1]),
                          dtype=torch.int32, device=dev)
        families = {"human padded": torch.cat([human_words, pad], 1)}
        for m in (3, 18):
            graph = scale if (w, m) == (2048, 3) else powerlaw_graph(
                32 * w, m, 16, seed=0)
            families[f"power-law m{m}"] = torch.from_numpy(
                graph.adj_bitmap.view("int32")).to(dev)
        for family, words in families.items():
            x32 = randn(32 * w, 128)
            for x in (x32, x32.to(torch.bfloat16)):
                tol = tol_of(x)
                want = bitmap_spmm_ref(words, x)
                csr = cs.spmm_csr(words, x.dtype)
                nnz = int(csr.values().numel())
                row = {"family": family, "words": w, "rows": words.shape[0],
                       "nnz": nnz, "dtype": str(x.dtype).split(".")[-1],
                       "planned": bs.plan(words.shape, x.shape, x.dtype),
                       "library_ms": cs.library_ms(torch.sparse.mm,
                                                   (csr, x))}
                del csr
                for route in ("split", "stream"):
                    cs.close_err(bs._launch(words, x, route), want, tol,
                                 max(tol, 1e-5))
                    row[f"{route}_ms"] = cs.device_ms(
                        lambda w_, x_, r=route: bs._launch(w_, x_, r),
                        [(words, x)])
                row["faster"] = min(("split", "stream"),
                                    key=lambda r: row[f"{r}_ms"])
                print(json.dumps(row), flush=True)
                del want
                torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
