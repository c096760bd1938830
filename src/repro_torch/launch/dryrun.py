"""Multi-pod dry-run (twin of ``repro.launch.dryrun``): count every
(arch x shape) cell on the production meshes, with no card and no
compiler, and record its roofline terms.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single

Each mesh is built over a fake process group of 256 (16 x 16) or 512
(2 x 16 x 16) ranks in this one process (``mesh.init_fake_group``); a
cell's arguments are ``meta`` ``DTensor``s placed by its specs, and one
run of its ``fn`` is counted on rank 0's shards (``roofline.hlo_cost``):
FLOPs, HBM bytes and collective bytes per device. Results land in
``experiments/dryrun/<arch>__<shape>__<mesh>.json`` with the reference's
keys. Keys with no counterpart here are ``null``:

  * ``compile_s``             — nothing is compiled;
  * ``memory_analysis``       — no compiler's memory plan;
  * ``coll_counts["xla_flops_ref"]`` — no XLA cost analysis.

``mem_per_device_bytes`` is the counter's own figure: this rank's
argument shards plus the most bytes its eager run held at once. A cell
whose figure passes one card's HBM (80 GB) is still ``"ok"`` (it was
counted; the reference records what its compiler planned, fitting or
not); the printed line marks it ``over-HBM``. ``lower_s`` is the
seconds to build the cell and place its arguments. A cell that fails,
or whose count runs past ``CELL_TIMEOUT_S`` seconds, is recorded with
``"status": "fail"`` and its error, and the run exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import signal
import sys
import time
import traceback


CELL_TIMEOUT_S = 600.0   # one cell's count; the slowest counted take ~80 s


def model_flops_of(arch: str, shape: str) -> float | None:
    """6 N T for a train step, 2 N T for a prefill or a decode step (N
    the activated parameters, T the tokens), as the reference counts
    them; None for other families."""
    from ..configs.registry import get_arch
    spec = get_arch(arch)
    if spec.family != "lm":
        return None
    c = spec.shape(shape)
    n = spec.config.n_active_params()
    if c.kind == "train":
        return 6.0 * n * c.dims["global_batch"] * c.dims["seq_len"]
    if c.kind == "prefill":
        return 2.0 * n * c.dims["global_batch"] * c.dims["seq_len"]
    return 2.0 * n * c.dims["global_batch"]


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


@contextlib.contextmanager
def time_limit(seconds: float | None):
    """Raise ``TimeoutError`` in this (main) thread after ``seconds``."""
    if not seconds:
        yield
        return

    def expire(signum, frame):
        raise TimeoutError(f"counting took more than {seconds:g} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: pathlib.Path,
             verbose: bool = True, timeout: float | None = None) -> dict:
    """Count one cell on the production mesh of the current (fake)
    process group and write its record; past ``timeout`` seconds the
    count stops with ``TimeoutError``."""
    from ..roofline.analysis import HBM_BYTES, analyze
    from ..roofline.hlo_cost import count_run
    from .mesh import make_production_mesh
    from .sharding import distribute
    from .steps import build_cell

    mesh = make_production_mesh(multi_pod=multi_pod)
    name = mesh_name(multi_pod)
    t0 = time.time()
    cell = build_cell(arch, shape, mesh)
    args = distribute(cell.args, cell.in_specs, mesh)
    t_lower = time.time() - t0
    t0 = time.time()
    with time_limit(timeout):
        cost = count_run(cell.fn, *args)
    t_count = time.time() - t0
    roof = analyze(arch, shape, name, mesh.size(), cost,
                   model_flops=model_flops_of(arch, shape))
    rec = roof.to_dict()
    rec.update({"lower_s": round(t_lower, 2), "compile_s": None,
                "memory_analysis": None, "status": "ok"})
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{arch}__{shape}__{name}.json"
    path.write_text(json.dumps(rec, indent=2, default=str))
    if verbose:
        print(f"[ok] {arch} x {shape} x {name}: count={t_count:.1f}s "
              f"flops/dev={rec['hlo_flops_per_device']:.3e} "
              f"coll/dev={rec['coll_bytes_per_device']:.3e} "
              f"mem/dev={rec['mem_per_device_bytes']:.3e} "
              f"bottleneck={rec['bottleneck']}"
              + (" over-HBM" if rec["mem_per_device_bytes"] > HBM_BYTES
                 else ""), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--include-matcher", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from ..configs.registry import all_cells
    from .mesh import init_fake_group
    out_dir = pathlib.Path(args.out)
    cells = (all_cells(include_matcher=args.include_matcher) if args.all
             else [(args.arch, args.shape)])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for mp in meshes:
        init_fake_group(512 if mp else 256)
        try:
            for arch, shape in cells:
                name = f"{arch}__{shape}__{mesh_name(mp)}"
                if args.skip_existing and (out_dir / f"{name}.json").exists():
                    print(f"[skip] {name}")
                    continue
                try:
                    run_cell(arch, shape, mp, out_dir,
                             timeout=CELL_TIMEOUT_S)
                except Exception as e:  # noqa: BLE001 — record, continue
                    traceback.print_exc()
                    failures.append((name, repr(e)))
                    out_dir.mkdir(parents=True, exist_ok=True)
                    (out_dir / f"{name}.json").write_text(json.dumps(
                        {"arch": arch, "shape": shape, "multi_pod": mp,
                         "status": "fail", "error": repr(e)}, indent=2))
        finally:
            dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for n, e in failures:
            print(" ", n, e[:200])
        return 1
    print("\nall cells counted OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
