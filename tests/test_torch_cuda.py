"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and the CUDA toolkit, and
skips without a card; the file imports neither JAX nor ``repro``, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Inputs come from numpy with a seed. The refine kernel is integer AND
over packed words: its output must equal the plain version bit for bit
(``torch.equal``, no tolerance).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.graph import build_hier_bitmap
from repro_torch.kernels import bitmap_refine
from repro_torch.kernels.ref import (refine_bitmap_rows_hier_ref,
                                     refine_bitmap_rows_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU "
                    "mode); run this file on the card")
    return torch.device("cuda")


def _inputs(v, f, np_, seed):
    rng = np.random.default_rng(seed)
    w = (v + 31) // 32
    adj = rng.integers(-2**31, 2**31, (v, w), dtype=np.int64)
    adj = (adj | rng.integers(-2**31, 2**31, (v, w), dtype=np.int64))
    cand = rng.integers(-2**31, 2**31, (f, w), dtype=np.int64)
    frontier = rng.integers(-1, v + 3, (f, np_))
    active = (rng.random((f, np_)) < 0.6).astype(np.int32)
    return [torch.from_numpy(a.astype(np.int32))
            for a in (adj, cand, frontier, active)]


@pytest.mark.parametrize("v,f,np_,seed", [
    (48, 3, 6, 0), (200, 21, 9, 2), (520, 40, 12, 3), (4674, 512, 64, 4),
    (33, 1, 64, 5)])
def test_cuda_refine_kernel_matches_plain(cuda_device, v, f, np_, seed):
    args = [t.to(cuda_device) for t in _inputs(v, f, np_, seed)]
    before = bitmap_refine.LAUNCHES
    got = bitmap_refine.refine_bitmap_rows(*args)
    torch.cuda.synchronize()
    assert bitmap_refine.LAUNCHES == before + 1
    assert torch.equal(got, refine_bitmap_rows_ref(*args))


def test_cuda_refine_kernel_rejects_bad_inputs(cuda_device):
    adj, cand, frontier, active = [t.to(cuda_device)
                                   for t in _inputs(64, 4, 8, 6)]
    with pytest.raises(TypeError):
        bitmap_refine.refine_bitmap_rows(adj, cand.long(), frontier, active)
    with pytest.raises(ValueError):
        bitmap_refine.refine_bitmap_rows(adj, cand[:, :1], frontier, active)
    with pytest.raises(ValueError):
        bitmap_refine.refine_bitmap_rows(adj, cand, frontier.cpu(), active)


def _hier_inputs(v, f, np_, cw, seed):
    """A random symmetric graph's two-level layout and refine inputs,
    with ``-1``, past-V and all-inactive rows among them."""
    rng = np.random.default_rng(seed)
    dense = rng.random((v, v)) < 0.2
    dense |= dense.T
    indptr = np.concatenate(([0], np.cumsum(dense.sum(axis=1))))
    hb = build_hier_bitmap(v, indptr, np.nonzero(dense)[1], chunk_words=cw)
    w = (v + 31) // 32
    cand = rng.integers(-2**31, 2**31, (f, w), dtype=np.int64)
    frontier = rng.integers(-1, v + 3, (f, np_))
    active = (rng.random((f, np_)) < 0.6).astype(np.int32)
    active[::5] = 0
    lanes = [hb.summary.view(np.int32), hb.chunk_ptr, hb.chunk_id,
             hb.chunk_data.view(np.int32)]
    return ([torch.from_numpy(a) for a in lanes], hb.kmax,
            [torch.from_numpy(a.astype(np.int32))
             for a in (cand, frontier, active)])


@pytest.mark.parametrize("v,f,np_,cw,seed", [
    (48, 6, 5, 1, 0), (300, 16, 8, 8, 1), (520, 24, 9, 4, 2),
    (64, 1, 3, 16, 3), (4096, 512, 64, 8, 4)])
def test_cuda_hier_refine_kernel_matches_plain(cuda_device, v, f, np_, cw,
                                               seed):
    lanes, kmax, rows = _hier_inputs(v, f, np_, cw, seed)
    args = ([t.to(cuda_device) for t in lanes], kmax,
            [t.to(cuda_device) for t in rows])
    before = bitmap_refine.HIER_LAUNCHES
    got = bitmap_refine.refine_bitmap_rows_hier(*args[0], kmax, *args[2])
    torch.cuda.synchronize()
    assert bitmap_refine.HIER_LAUNCHES == before + 1
    assert torch.equal(got, refine_bitmap_rows_hier_ref(*args[0], kmax,
                                                        *args[2]))


def test_cuda_hier_refine_kernel_rejects_bad_inputs(cuda_device):
    lanes, kmax, (cand, frontier, active) = _hier_inputs(64, 4, 8, 4, 6)
    lanes = [t.to(cuda_device) for t in lanes]
    cand, frontier, active = (t.to(cuda_device)
                              for t in (cand, frontier, active))
    refine = bitmap_refine.refine_bitmap_rows_hier
    with pytest.raises(TypeError):
        refine(*lanes, kmax, cand.long(), frontier, active)
    with pytest.raises(ValueError):
        refine(*lanes[:3], lanes[3][:, :3].contiguous(), kmax, cand,
               frontier, active)
    with pytest.raises(ValueError):
        refine(*lanes, kmax, cand, frontier.cpu(), active)
