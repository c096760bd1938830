"""Kernel-backend and device policy shared by every kernel call site.

Two backends:

  * ``"torch"`` — the plain PyTorch version of each kernel (``ref.py``);
  * ``"cuda"``  — the hand-written CUDA kernel (``csrc/``).

By default the backend is decided by the tensor a wrapper is given: a
CUDA tensor goes to the kernel, a CPU tensor to the plain version. A
call may name its own (``backend=`` on every wrapper and op, for that
call only). A process-wide forced backend comes from
``REPRO_TORCH_KERNEL_BACKEND`` (its own variable: the JAX package's
``REPRO_KERNEL_BACKEND`` rejects names it does not know) or from
:func:`backend_scope`. Forcing ``"torch"`` on a
CUDA tensor runs the plain version on the card — the comparison phase
of ``chip_smoke.py`` uses exactly that. Forcing ``"cuda"`` on a CPU
tensor raises: nothing silently falls back.
"""
from __future__ import annotations

import contextlib
import os

import torch

BACKENDS = ("torch", "cuda")
ENV_VAR = "REPRO_TORCH_KERNEL_BACKEND"

DEFAULT_BLOCK_F = 8     # refine row-block height, kept for knob parity
                        # with the reference (the CUDA kernel does not
                        # read it: one block per row)

DEFAULT_CHUNK_WORDS = 8  # hierarchical layout: packed words per chunk
                         # (C) — 256 vertices of coverage per summary bit
DEFAULT_DMA_DEPTH = 2    # kept for knob parity with the reference's
                         # chunk-copy pipeline (the CUDA kernel does not
                         # read it)

# Dense/hierarchical threshold, as in the reference: at or above this
# many data-graph vertices the two-level layout (core.graph.HierBitmap)
# and the hierarchical refine kernel are used. Where the threshold
# belongs on Hopper is a tuning question: the dense block of a 64K-vertex
# graph (537 MB) would fit on the card.
HBM_ADJACENCY_MIN_VERTICES = 16384


def _from_env() -> str | None:
    name = os.environ.get(ENV_VAR) or None
    if name is not None and name not in BACKENDS:
        raise ValueError(f"{ENV_VAR}={name!r} not in {BACKENDS}")
    return name


_forced: str | None = _from_env()


def get_backend() -> str | None:
    """The forced backend, or None when the tensor's device decides."""
    return _forced


def set_backend(name: str | None) -> None:
    global _forced
    if name is not None and name not in BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; "
                         f"choose one of {BACKENDS}")
    _forced = name


@contextlib.contextmanager
def backend_scope(name: str | None):
    """Temporarily force a backend (save/restore, exception-safe)."""
    prev = get_backend()
    set_backend(name)
    try:
        yield name
    finally:
        set_backend(prev)


def backend_for(t: torch.Tensor, backend: str | None = None) -> str:
    """Backend for a call on tensor ``t``: ``backend`` when the caller
    names one (for this call only), else the forced one, else the kernel
    for a CUDA tensor and the plain version for a CPU tensor."""
    name = _forced if backend is None else backend
    if name is None:
        return "cuda" if t.is_cuda else "torch"
    if name not in BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; choose one of "
                         f"{BACKENDS} or None")
    if name == "cuda" and not t.is_cuda:
        raise RuntimeError(f"kernel backend 'cuda' forced for a tensor on "
                           f"{t.device}")
    return name


def kernel_chunk_words(n_vertices: int | None = None) -> int:
    """Hierarchical chunk width C (words per chunk). The port has no
    tuning cache yet, so this is the built-in default at every size."""
    return DEFAULT_CHUNK_WORDS


def kernel_dma_depth(n_vertices: int | None = None) -> int:
    """Chunk-copy depth of the hierarchical refine (built-in default;
    accepted for parity, not read by the CUDA kernel)."""
    return DEFAULT_DMA_DEPTH


def use_hbm_adjacency(n_vertices: int | None) -> bool:
    """Whether the reference would pick the hierarchical layout."""
    return (n_vertices is not None
            and int(n_vertices) >= HBM_ADJACENCY_MIN_VERTICES)


def resolve_device(device) -> torch.device:
    """The port's device rule: ``"cuda"`` (the default everywhere)
    needs a card and raises without one — never a CPU fallback; tests
    pass ``"cpu"`` explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch needs a CUDA device (device='cuda' is the "
            "default); pass device='cpu' to run the plain versions")
    return dev
