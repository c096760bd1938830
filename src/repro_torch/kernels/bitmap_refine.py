"""Eq. 2 refinement kernel: wrapper, build and launch count.

:func:`refine_bitmap_rows` is the port of the reference's Pallas kernel
of the same name (``repro/kernels/bitmap_refine.py``). For a CUDA tensor
it launches the hand-written kernel in ``csrc/bitmap_refine.cu``; for a
CPU tensor it runs the plain version, ``ref.refine_bitmap_rows_ref``.
There is no fallback from one to the other: a CUDA call either launches
or raises.

The kernel is compiled with ``nvcc`` into a shared library with a plain
C interface and bound with ``ctypes`` — seconds to build, against the
minutes a source that includes PyTorch's headers takes. The build runs
at first use, into ``build/repro_torch/`` at the repository root (listed
in ``.gitignore``), keyed by a hash of the source, so importing this
module builds nothing.
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

import torch

from .config import backend_for
from .ref import refine_bitmap_rows_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitmap_refine.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
MAX_POSITIONS = 64

LAUNCHES = 0            # kernel launches made by refine_bitmap_rows
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernel can only be "
                           "built on a machine with the CUDA toolkit")
    return path


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile the kernel library if it is not built yet.

    Returns ``(library path, build seconds, compiler output)``; seconds
    is 0.0 when a library for this exact source already existed.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills).
    """
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"libbitmap_refine_{digest}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, secs, proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.refine_bitmap_rows_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, device: torch.device,
           ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refine_bitmap_rows(adj_bitmap: torch.Tensor, cand_rows: torch.Tensor,
                       frontier: torch.Tensor, active: torch.Tensor
                       ) -> torch.Tensor:
    """Eq. 2 refinement with per-row candidates and active positions.

    ``adj_bitmap`` int32 [V, W], ``cand_rows`` int32 [F, W], ``frontier``
    int32 [F, NP] (-1 unmapped), ``active`` int32 [F, NP]; returns int32
    [F, W]. Same semantics as ``ref.refine_bitmap_rows_ref``.
    """
    if backend_for(cand_rows) == "torch":
        return refine_bitmap_rows_ref(adj_bitmap, cand_rows, frontier,
                                      active)
    global LAUNCHES
    dev = cand_rows.device
    for name, t, nd in (("adj_bitmap", adj_bitmap, 2),
                        ("cand_rows", cand_rows, 2),
                        ("frontier", frontier, 2), ("active", active, 2)):
        _check(name, t, dev, nd)
    v, w = adj_bitmap.shape
    f, np_ = frontier.shape
    if cand_rows.shape != (f, w) or active.shape != (f, np_):
        raise ValueError("shape mismatch: adj [V, W], cand [F, W], "
                         "frontier/active [F, NP]")
    if np_ > MAX_POSITIONS or v < 1:
        raise ValueError(f"need 1 <= V and NP <= {MAX_POSITIONS}")
    out = torch.empty_like(cand_rows)
    if f == 0 or w == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().refine_bitmap_rows_launch(
        adj_bitmap.data_ptr(), cand_rows.data_ptr(), frontier.data_ptr(),
        active.data_ptr(), out.data_ptr(), v, w, f, np_, stream)
    if err != 0:
        raise RuntimeError(f"refine_bitmap_rows launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
