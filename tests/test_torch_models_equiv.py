"""The port's equivariant potentials (``repro_torch.models.equivariant``:
NequIP-lite and MACE-lite) against the JAX package's, on the CPU, for
every equiv entry of the registry at its smoke config (float32), with
and without edge chunks.

Inputs come from ``np.random.default_rng(seed)``; weights from the
reference's ``equiv_init(jax.random.key(k), cfg)``, carried over by
``repro_torch.convert.equiv_params``. Tolerances: energies and losses
within rtol 1e-4, atol 1e-5; forces (a gradient) and parameter
gradients within rtol 1e-3, atol 1e-5; the rotation checks within the
tolerances of ``tests/test_archs.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import equivariant as JE
from repro_torch import convert
from repro_torch.configs.registry import ARCHS
from repro_torch.models import equivariant as TE

F32 = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
EQ_ARCHS = [a for a, s in ARCHS.items() if s.family == "equiv"]


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _n(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol=F32, **kw):
    np.testing.assert_allclose(_n(got), np.asarray(want, np.float32),
                               **tol, **kw)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _grads_close(module, loss, want_tree):
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    want = convert.flatten_params(_tree(want_tree))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        _close(g, want[name], GRAD, err_msg=name)


def _equiv(arch, seed=0, **replace):
    jcfg = dataclasses.replace(J_ARCHS[arch].smoke_config, **replace)
    tcfg = dataclasses.replace(ARCHS[arch].smoke_config, **replace)
    jp = jax.jit(JE.equiv_init, static_argnums=1)(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, convert.equiv_params(_tree(jp), tcfg, "cpu")


def _mol(cfg, n=12, seed=0):
    """All pairs within the cutoff as directed edges (as
    ``tests/test_archs.py`` builds them)."""
    rng = np.random.default_rng(seed)
    species = rng.integers(0, cfg.n_species, n).astype(np.int32)
    pos = (rng.standard_normal((n, 3)) * 2.0).astype(np.float32)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    src, dst = np.nonzero((d < cfg.cutoff) & (d > 0))
    return species, pos, np.stack([src, dst]).astype(np.int32)


@pytest.mark.parametrize("arch", EQ_ARCHS)
@pytest.mark.parametrize("edge_chunk", [0, 16])
def test_equiv_energy_and_forces(arch, edge_chunk):
    jcfg, tcfg, jp, tp = _equiv(arch, edge_chunk=edge_chunk)
    species, pos, ei = _mol(jcfg)
    assert ei.shape[1] > 2 * max(edge_chunk, 1)
    want_e, want_f = jax.jit(JE.equiv_forces, static_argnums=1)(
        jp, jcfg, species, pos, ei)
    with torch.no_grad():
        e, f = TE.equiv_forces(tp, tcfg, _t(species), _t(pos), _t(ei))
    assert not e.requires_grad and not f.requires_grad
    _close(e, want_e)
    _close(f, want_f, GRAD)
    _close(TE.equiv_energy(tp, tcfg, _t(species), _t(pos), _t(ei)), want_e)


def _mol_batch(cfg, n_graphs=3, seed=1):
    parts = [_mol(cfg, n=8, seed=seed + g) for g in range(n_graphs)]
    species = np.concatenate([p[0] for p in parts])
    pos = np.concatenate([p[1] for p in parts])
    ei = np.concatenate([p[2] + 8 * g for g, p in enumerate(parts)], axis=1)
    rng = np.random.default_rng(seed)
    return {"species": species, "positions": pos, "edge_index": ei,
            "graph_id": np.repeat(np.arange(n_graphs), 8).astype(np.int32),
            "energy": rng.standard_normal(n_graphs).astype(np.float32),
            "forces": rng.standard_normal(pos.shape).astype(np.float32)}


@pytest.mark.parametrize("arch", EQ_ARCHS)
@pytest.mark.parametrize("edge_chunk", [0, 16])
def test_equiv_batched_loss_with_forces_and_its_gradients(arch, edge_chunk):
    """The loss holds a force term (a gradient taken with
    ``create_graph=True``); its parameter gradients go through that
    gradient, and through the recomputed edge chunks."""
    jcfg, tcfg, jp, tp = _equiv(arch, seed=1, edge_chunk=edge_chunk)
    batch = _mol_batch(jcfg)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: JE.equiv_batched_loss(p, jcfg, batch, 3)))(jp)
    loss = TE.equiv_batched_loss(tp, tcfg, {k: _t(v) for k, v in
                                            batch.items()}, 3)
    _close(loss, want_loss)
    _grads_close(tp, loss, want)


@pytest.mark.parametrize("arch", EQ_ARCHS)
def test_equiv_energy_loss(arch):
    jcfg, tcfg, jp, tp = _equiv(arch, seed=2)
    species, pos, ei = _mol(jcfg, seed=3)
    rng = np.random.default_rng(3)
    batch = {"species": species, "positions": pos, "edge_index": ei,
             "energy": np.float32(rng.standard_normal()),
             "forces": rng.standard_normal(pos.shape).astype(np.float32)}
    with torch.no_grad():
        got = TE.equiv_energy_loss(tp, tcfg, {k: _t(v) for k, v in
                                              batch.items()})
    _close(got, jax.jit(JE.equiv_energy_loss, static_argnums=1)(jp, jcfg,
                                                              batch))


def _rotation(seed=3):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


@pytest.mark.parametrize("arch", EQ_ARCHS)
def test_equiv_rotation_invariance(arch):
    """E(3): the port's energy is invariant and its forces covariant
    under a rotation (the tolerances of ``tests/test_archs.py``)."""
    _, tcfg, _, tp = _equiv(arch, seed=2)
    species, pos, ei = _mol(tcfg, seed=5)
    rot = _rotation()
    with torch.no_grad():
        e1, f1 = TE.equiv_forces(tp, tcfg, _t(species), _t(pos), _t(ei))
        e2, f2 = TE.equiv_forces(tp, tcfg, _t(species), _t(pos @ rot.T),
                                 _t(ei))
    np.testing.assert_allclose(float(e1), float(e2), rtol=1e-4)
    np.testing.assert_allclose(_n(f1) @ rot.T, _n(f2), rtol=1e-3, atol=1e-4)


def test_bessel_basis_and_traceless_sym():
    rng = np.random.default_rng(4)
    r = np.abs(rng.standard_normal(30)).astype(np.float32) * 3
    _close(TE.bessel_basis(_t(r), 8, 5.0), JE.bessel_basis(r, 8, 5.0))
    m = rng.standard_normal((5, 4, 3, 3)).astype(np.float32)
    _close(TE._traceless_sym(_t(m)), JE._traceless_sym(m))
