"""Build and load the port's CUDA kernels.

Each kernel in ``csrc/`` is compiled with ``nvcc`` into a shared library
with a plain C interface and bound with ``ctypes`` — seconds to build,
against the minutes a source that includes PyTorch's headers takes. The
build runs at first use, into ``build/repro_torch/`` at the repository
root (listed in ``.gitignore``), keyed by a hash of the source, so
importing a kernel module builds nothing. :func:`build_all` compiles
every source at once, one ``nvcc`` process each.

Each wrapper module keeps its kernel's ``ctypes`` signature beside it
and hands it to :func:`load`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"refine_bitmap_rows": CSRC / "bitmap_refine.cu",
           "refine_bitmap_rows_hier": CSRC / "bitmap_refine_hier.cu",
           "bitmap_spmm": CSRC / "bitmap_spmm.cu",
           "flash_attention": CSRC / "flash_attention.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels can only be "
                           "built on a machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_all(names=None, verbose: bool = False
              ) -> dict[str, tuple[Path, float, str]]:
    """Compile the named kernel libraries (all by default) that are not
    built yet, one ``nvcc`` process each, all started together.

    Returns ``{name: (library path, build seconds, compiler output)}``;
    seconds is 0.0 for a library that already existed for this exact
    source. ``verbose`` adds ``-Xptxas -v`` (registers, shared memory,
    spills).
    """
    names = list(SOURCES) if names is None else list(names)
    done, running = {}, {}
    for name in names:
        lib = _target(name)
        if lib.exists():
            done[name] = (lib, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in running.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {SOURCES[name].name} "
                          f"({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        done[name] = (lib, secs, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str, signatures: dict[str, tuple[list, object]]
         ) -> ctypes.CDLL:
    """The kernel library ``name``, built first if need be. On first
    load each ``symbol: (argtypes, restype)`` of ``signatures`` is set
    on it: a pointer or the stream is ``ctypes.c_void_p``, or ctypes
    would pass a 32-bit int and cut it."""
    if name not in _libs:
        path, _, _ = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        for symbol, (argtypes, restype) in signatures.items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, restype
        _libs[name] = lib
    return _libs[name]
