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

This module is also where the kernel-layout knobs resolve (the tuning
layer, ``repro_torch.tuning``): :func:`use_hbm_adjacency`,
:func:`kernel_chunk_words`, :func:`kernel_dma_depth` and
:func:`kernel_block_f` give scope override (:func:`kernel_param_scope`)
> tuning-cache record for the backend, device kind and graph size >
built-in default. :func:`device_backend` names the backend a device's
kernels take, which keys the record.
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
# and the hierarchical refine kernel are used. A tuning record or a
# kernel_param_scope override ("hbm_adjacency") wins over it. Where the
# threshold belongs on Hopper is a tuning question: the dense block of a
# 64K-vertex graph (537 MB) would fit on the card.
HBM_ADJACENCY_MIN_VERTICES = 16384

# scope-local kernel parameter overrides (kernel_param_scope): the
# "explicit" level of the tuning resolution order
_kernel_overrides: dict[str, int] = {}


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


@contextlib.contextmanager
def kernel_param_scope(**params: int):
    """Temporarily pin kernel-layout parameters (``block_f``,
    ``hbm_adjacency``, ``chunk_words``, ``dma_depth``): the
    explicit-override level of the resolution order, used by the tuner
    to measure candidate points and by tests to pin a layout."""
    global _kernel_overrides
    prev = dict(_kernel_overrides)
    _kernel_overrides.update({k: int(v) for k, v in params.items()})
    try:
        yield dict(_kernel_overrides)
    finally:
        _kernel_overrides = prev


def kernel_override(name: str) -> int | None:
    """The active :func:`kernel_param_scope` override for ``name``."""
    return _kernel_overrides.get(name)


def device_backend(device=None) -> str:
    """The backend the kernels take on ``device`` (default: the card,
    as every entry point's): the forced one, else ``"cuda"`` on a CUDA
    device and ``"torch"`` on the CPU. A scheduler keys its tuning
    lookup by it."""
    if _forced is not None:
        return _forced
    dev = resolve_device() if device is None else torch.device(device)
    return "cuda" if dev.type == "cuda" else "torch"


def _tuned_param(name: str, backend: str | None, n_vertices: int | None,
                 device=None) -> int | None:
    """Shared knob lookup: scope override > tuning-cache record for
    (backend, device kind, |V| bucket) > None (the caller's built-in).
    ``backend`` None means the backend of ``device``."""
    v = _kernel_overrides.get(name)
    if v is not None:
        return int(v)
    if n_vertices is None:
        return None
    from ..tuning.cache import device_kind, load_default_cache
    from ..tuning.resolve import tuning_enabled
    if not tuning_enabled():
        return None
    rec = load_default_cache().lookup(
        backend or device_backend(device), device_kind(device), n_vertices)
    if rec and name in rec["params"]:
        return int(rec["params"][name])
    return None


def kernel_block_f(backend: str | None = None,
                   n_vertices: int | None = None, device=None) -> int:
    """Resolved refine row-block height: scope override > tuning-cache
    record > ``DEFAULT_BLOCK_F`` (the engine knob ``block_f`` that
    ``tuning.resolve`` reports). Kept for knob parity: no CUDA kernel
    reads it."""
    v = _tuned_param("block_f", backend, n_vertices, device)
    return DEFAULT_BLOCK_F if v is None else v


def kernel_chunk_words(backend: str | None = None,
                       n_vertices: int | None = None, device=None) -> int:
    """Hierarchical chunk width C (words per chunk): scope override >
    tuning-cache record > ``DEFAULT_CHUNK_WORDS``."""
    v = _tuned_param("chunk_words", backend, n_vertices, device)
    return DEFAULT_CHUNK_WORDS if v is None else v


def kernel_dma_depth(backend: str | None = None,
                     n_vertices: int | None = None, device=None) -> int:
    """Chunk-copy depth of the hierarchical refine, same order as
    :func:`kernel_chunk_words` (accepted for parity, not read by the
    CUDA kernel)."""
    v = _tuned_param("dma_depth", backend, n_vertices, device)
    return DEFAULT_DMA_DEPTH if v is None else max(1, v)


def use_hbm_adjacency(backend: str | None = None,
                      n_vertices: int | None = None, device=None) -> bool:
    """Whether the two-level layout is used at this graph size: scope
    override (``hbm_adjacency``, 0/1) > tuning-cache record > the
    ``HBM_ADJACENCY_MIN_VERTICES`` threshold."""
    v = _tuned_param("hbm_adjacency", backend, n_vertices, device)
    if v is not None:
        return bool(v)
    return (n_vertices is not None
            and int(n_vertices) >= HBM_ADJACENCY_MIN_VERTICES)


def resolve_device(device=None) -> torch.device:
    """The port's device rule: ``"cuda"`` (the default everywhere, and
    what None means) needs a card and raises without one — never a CPU
    fallback; tests pass ``"cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch needs a CUDA device (device='cuda' is the "
            "default); pass device='cpu' to run the plain versions")
    return dev
