"""The port's Eq. 2 refine (``repro_torch.kernels``) against the JAX
package's, on the grids of ``tests/test_kernels.py``.

The port's plain version is held against the reference's
``refine_bitmap_rows_ref`` and against the Pallas kernel run as that
file runs it (``backend="pallas_interpret"``). The kernel wrapper given
CPU tensors must take the plain path. Inputs are made
by numpy from a seed. Every lane is a packed bitmap word, so every
comparison is exact (no tolerance). The CUDA kernel's own test, which
needs a card, is ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.graph import pack_bitmap
from repro.kernels import ref as jref
from repro.kernels.ops import refine_bitmap_op, refine_bitmap_rows_op
from repro_torch.kernels import bitmap_refine, config
from repro_torch.kernels.ref import refine_bitmap_rows_ref

torch.set_num_threads(1)


def _inputs(v, f, np_, seed, per_row=True):
    rng = np.random.default_rng(seed)
    dense = rng.random((v, v)) < 0.2
    dense |= dense.T
    adj = pack_bitmap(dense)
    if per_row:
        cand = pack_bitmap(rng.random((f, v)) < 0.5)
        active = (rng.random((f, np_)) < 0.6).astype(np.int32)
    else:
        cand = pack_bitmap(rng.random((1, v)) < 0.5)[0]
        active = (rng.random(np_) < 0.6).astype(np.int32)
    frontier = rng.integers(-1, v, size=(f, np_)).astype(np.int32)
    return adj, cand, frontier, active


def _t(a):
    a = np.array(a)                  # a writable, contiguous copy
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a)


def _port(adj, cand, frontier, active):
    return refine_bitmap_rows_ref(_t(adj), _t(cand), _t(frontier),
                                  _t(active)).numpy()


@pytest.mark.parametrize("v,f,np_,seed", [
    (48, 3, 6, 0), (96, 8, 7, 1), (200, 21, 9, 2), (520, 40, 12, 3),
])
def test_refine_rows_plain_matches_reference(v, f, np_, seed):
    adj, cand, frontier, active = _inputs(v, f, np_, seed)
    got = _port(adj, cand, frontier, active)
    want_ref = np.asarray(jref.refine_bitmap_rows_ref(
        jnp.asarray(adj), jnp.asarray(cand), jnp.asarray(frontier),
        jnp.asarray(active)))
    want_pallas = np.asarray(refine_bitmap_rows_op(
        jnp.asarray(adj), jnp.asarray(cand), jnp.asarray(frontier),
        jnp.asarray(active), backend="pallas_interpret"))
    np.testing.assert_array_equal(got, want_ref.view(np.int32))
    np.testing.assert_array_equal(got, want_pallas.view(np.int32))


@pytest.mark.parametrize("v,f,np_,seed", [
    (33, 4, 5, 0), (128, 16, 8, 1), (300, 32, 12, 2), (64, 1, 3, 3),
])
def test_refine_broadcast_plain_matches_reference(v, f, np_, seed):
    """The single-query form (one candidate row and one active vector
    for every row), broadcast into the port's per-row function."""
    adj, cand, frontier, active = _inputs(v, f, np_, seed, per_row=False)
    got = _port(adj, np.broadcast_to(cand, (f, cand.shape[0])), frontier,
                np.broadcast_to(active, (f, np_)))
    want = np.asarray(refine_bitmap_op(
        jnp.asarray(adj), jnp.asarray(cand), jnp.asarray(frontier),
        jnp.asarray(active), backend="pallas_interpret"))
    np.testing.assert_array_equal(got, want.view(np.int32))


def test_refine_no_active_positions_returns_candidates():
    v = 70
    rng = np.random.default_rng(0)
    adj = pack_bitmap(rng.random((v, v)) < 0.3)
    cand = pack_bitmap(rng.random((3, v)) < 0.5)
    got = _port(adj, cand, np.full((3, 4), -1, np.int32),
                np.ones((3, 4), np.int32))
    np.testing.assert_array_equal(got, cand.view(np.int32))
    got = _port(adj, cand, np.zeros((3, 4), np.int32),
                np.zeros((3, 4), np.int32))
    np.testing.assert_array_equal(got, cand.view(np.int32))


def test_wrapper_takes_plain_path_for_cpu_tensors(monkeypatch):
    """A CPU tensor runs the plain version: no build, no launch."""
    monkeypatch.setattr(bitmap_refine, "_library", lambda: pytest.fail(
        "the CUDA library was requested for CPU tensors"))
    before = bitmap_refine.LAUNCHES
    adj, cand, frontier, active = _inputs(200, 21, 9, 2)
    got = bitmap_refine.refine_bitmap_rows(_t(adj), _t(cand),
                                           _t(frontier), _t(active))
    np.testing.assert_array_equal(got.numpy(),
                                  _port(adj, cand, frontier, active))
    assert bitmap_refine.LAUNCHES == before
    assert config.backend_for(_t(cand)) == "torch"


def test_forcing_the_kernel_on_cpu_tensors_raises():
    adj, cand, frontier, active = _inputs(48, 3, 6, 0)
    with config.backend_scope("cuda"):
        with pytest.raises(RuntimeError, match="forced"):
            bitmap_refine.refine_bitmap_rows(_t(adj), _t(cand),
                                             _t(frontier), _t(active))
    assert config.get_backend() is None


def test_backend_env_var_is_the_ports_own():
    """The port reads its own variable; the reference's
    REPRO_KERNEL_BACKEND values mean nothing to it."""
    assert config.ENV_VAR != "REPRO_KERNEL_BACKEND"
    with pytest.raises(ValueError):
        config.set_backend("pallas")


@pytest.mark.parametrize("backend", [None, "torch", "cuda"])
def test_refine_entry_points_refuse_a_dtensor(backend):
    """A ``DTensor``'s ``data_ptr()`` is 0, so no kernel may be handed
    one: each refine entry point raises ``TypeError`` naming the
    argument, before any backend choice (a forced ``"cuda"`` on these
    CPU tensors would raise ``RuntimeError`` there), and launches
    nothing."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.core.graph import build_hier_bitmap
    from repro_torch.launch import mesh as T_MESH
    adj, cand, frontier, active = (_t(a) for a in _inputs(48, 3, 6, 0))
    dense = adj.numpy().view(np.uint32)
    rows = [np.flatnonzero(np.unpackbits(r.view(np.uint8),
                                         bitorder="little")[:48])
            for r in dense]
    hb = build_hier_bitmap(48, np.cumsum([0] + [len(r) for r in rows]),
                           np.concatenate(rows), chunk_words=1)
    lanes = [_t(hb.summary), _t(hb.chunk_ptr), _t(hb.chunk_id),
             _t(hb.chunk_data)]
    T_MESH.init_fake_group(1)
    try:
        mesh = T_MESH.make_host_test_mesh()

        def dt(t):
            return DTensor.from_local(t, mesh, [Replicate()] * 2,
                                      run_check=False)
        before = (bitmap_refine.LAUNCHES, bitmap_refine.HIER_LAUNCHES)
        for i, name in enumerate(("adj_bitmap", "cand_rows", "frontier",
                                  "active")):
            args = [adj, cand, frontier, active]
            args[i] = dt(args[i])
            with pytest.raises(TypeError, match=name):
                bitmap_refine.refine_bitmap_rows(*args, backend=backend)
        names = ("summary", "chunk_ptr", "chunk_id", "chunk_data",
                 "cand_rows", "frontier", "active")
        for i, name in enumerate(names):
            args = lanes + [cand, frontier, active]
            args[i] = dt(args[i])
            with pytest.raises(TypeError, match=name):
                bitmap_refine.refine_bitmap_rows_hier(
                    *args[:4], hb.kmax, *args[4:], backend=backend)
        assert (bitmap_refine.LAUNCHES,
                bitmap_refine.HIER_LAUNCHES) == before
    finally:
        dist.destroy_process_group()
