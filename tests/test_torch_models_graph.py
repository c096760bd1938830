"""The port's GNNs and DIN (``repro_torch.models.gnn``, ``recsys``) and
its neighbour sampler (``repro_torch.data.sampler``) against the JAX
package's, on the CPU, for every gnn and recsys entry of the registry at
its smoke config (all float32).

Inputs come from ``np.random.default_rng(seed)``; weights from the
reference's ``*_init(jax.random.key(k), cfg)``, carried over by
``repro_torch.convert``. Tolerances: outputs, energies and losses within
rtol 1e-4, atol 1e-5; gradients within rtol 1e-3, atol 1e-5; sampler blocks bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.data.sampler import NeighborSampler as JSampler
from repro.models import gnn as JG
from repro.models import recsys as JR
from repro_torch import convert
from repro_torch.configs.registry import ARCHS
from repro_torch.data.sampler import NeighborSampler as TSampler
from repro_torch.models import gnn as TG
from repro_torch.models import recsys as TR

F32 = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
GNN_ARCHS = [a for a, s in ARCHS.items() if s.family == "gnn"]


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


# ---------------------------------------------------------------- gnn
def _gnn(arch, seed=0, **replace):
    jcfg = dataclasses.replace(J_ARCHS[arch].smoke_config, **replace)
    tcfg = dataclasses.replace(ARCHS[arch].smoke_config, **replace)
    jp = JG.gnn_init(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, convert.gnn_params(_tree(jp), tcfg, "cpu")


def _graph(rng, n=40, e=120):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return np.stack([np.concatenate([src, dst]),
                     np.concatenate([dst, src])]).astype(np.int32)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_full_batch_forward_loss_and_gradients(arch):
    jcfg, tcfg, jp, tp = _gnn(arch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, jcfg.d_in)).astype(np.float32)
    ei = _graph(rng)
    labels = rng.integers(0, jcfg.n_classes, 40).astype(np.int32)
    mask = (rng.random(40) < 0.5).astype(np.float32)
    _close(TG.gnn_forward_full(tp, tcfg, _t(x), _t(ei)),
           JG.gnn_forward_full(jp, jcfg, x, ei))
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: JG.gnn_loss(p, jcfg, x, ei, labels, mask)))(jp)
    loss = TG.gnn_loss(tp, tcfg, _t(x), _t(ei), _t(labels), _t(mask))
    _close(loss, want_loss)
    _grads_close(tp, loss, want)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_batched_small_graphs(arch):
    jcfg, tcfg, jp, tp = _gnn(arch, seed=1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, jcfg.d_in)).astype(np.float32)
    ei = _graph(rng)
    gid = np.sort(rng.integers(0, 4, 40)).astype(np.int32)
    _close(TG.gnn_forward_batched(tp, tcfg, _t(x), _t(ei), _t(gid), 4),
           JG.gnn_forward_batched(jp, jcfg, x, ei, gid, 4))


def _csr(rng, n=60, e=200):
    ei = _graph(rng, n, e)
    order = np.argsort(ei[1], kind="stable")
    src, dst = ei[0][order], ei[1][order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    return np.cumsum(indptr), src.astype(np.int64)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_sampled_forward_on_the_same_sampler_blocks(arch):
    """Both packages' ``NeighborSampler`` with one seed give the same
    blocks (bit for bit); the sampled forward on them agrees."""
    n_layers = ARCHS[arch].smoke_config.n_layers
    fanouts = (4, 3, 2)[:n_layers]
    jcfg, tcfg, jp, tp = _gnn(arch, seed=2)
    rng = np.random.default_rng(2)
    indptr, indices = _csr(rng)
    feats = rng.standard_normal((60, jcfg.d_in)).astype(np.float32)
    seeds = np.array([0, 5, 9, 31, 59])
    j_out = JSampler(indptr, indices, fanouts, seed=7).sample_padded(seeds,
                                                                    feats)
    t_out = TSampler(indptr, indices, fanouts, seed=7).sample_padded(seeds,
                                                                    feats)
    for j_part, t_part in zip(j_out, t_out):
        for a, b in zip(j_part, t_part):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    fl, idx, valid = t_out
    _close(TG.gnn_forward_sampled(tp, tcfg, [_t(f) for f in fl],
                                  [_t(i) for i in idx],
                                  [_t(v) for v in valid]),
           JG.gnn_forward_sampled(jp, jcfg, fl, idx, valid))


def test_sampler_levels_equal():
    rng = np.random.default_rng(3)
    indptr, indices = _csr(rng)
    seeds = np.array([1, 2, 3, 40])
    j = JSampler(indptr, indices, (5, 5), seed=11).sample(seeds)
    t = TSampler(indptr, indices, (5, 5), seed=11).sample(seeds)
    for j_part, t_part in zip(j, t):
        for a, b in zip(j_part, t_part):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- din
def _din(seed=0):
    jcfg, tcfg = J_ARCHS["din"].smoke_config, ARCHS["din"].smoke_config
    jp = jax.jit(JR.din_init, static_argnums=1)(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, convert.din_params(_tree(jp), tcfg, "cpu")


def _din_batch(cfg, b=16, seed=0):
    rng = np.random.default_rng(seed)
    L = cfg.seq_len
    return {
        "target_item": rng.integers(0, cfg.n_items, b),
        "target_cat": rng.integers(0, cfg.n_cats, b),
        "hist_items": rng.integers(0, cfg.n_items, (b, L)),
        "hist_cats": rng.integers(0, cfg.n_cats, (b, L)),
        "hist_mask": (rng.random((b, L)) < 0.7).astype(np.float32),
        "dense_feats": rng.standard_normal(
            (b, cfg.n_dense_feats)).astype(np.float32),
        "labels": rng.integers(0, 2, b)}


def test_din_forward_loss_and_gradients():
    jcfg, tcfg, jp, tp = _din()
    batch = _din_batch(jcfg)
    tb = {k: _t(v) for k, v in batch.items()}
    _close(TR.din_forward(tp, tcfg, tb),
           jax.jit(JR.din_forward, static_argnums=1)(jp, jcfg, batch))
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: JR.din_loss(p, jcfg, batch)))(jp)
    loss = TR.din_loss(tp, tcfg, tb)
    _close(loss, want_loss)
    _grads_close(tp, loss, want)


def test_din_score_candidates():
    jcfg, tcfg, jp, tp = _din(seed=1)
    batch = _din_batch(jcfg, seed=1)
    user = {k: batch[k][0] for k in ("hist_items", "hist_cats",
                                     "hist_mask", "dense_feats")}
    rng = np.random.default_rng(2)
    items = rng.integers(0, jcfg.n_items, 64)
    cats = rng.integers(0, jcfg.n_cats, 64)
    with torch.no_grad():
        got = TR.din_score_candidates(tp, tcfg,
                                      {k: _t(v) for k, v in user.items()},
                                      _t(items), _t(cats))
    _close(got, JR.din_score_candidates(jp, jcfg, user, items, cats))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag(mode):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    idx = rng.integers(0, 50, 40).astype(np.int32)
    seg = rng.integers(0, 9, 40).astype(np.int32)    # bag 9 stays empty
    _close(TR.embedding_bag(_t(table), _t(idx), _t(seg), 10, mode),
           JR.embedding_bag(table, idx, seg, 10, mode))
    fixed = TR.embedding_bag(torch.arange(20.).reshape(10, 2),
                             torch.tensor([0, 1, 2, 5, 5]),
                             torch.tensor([0, 0, 1, 1, 2]), 4, mode)
    want = {"sum": [2.0, 4.0], "mean": [1.0, 2.0]}[mode]
    _close(fixed[0], np.array(want))
    _close(fixed[3], np.zeros(2))


def test_segment_sum_matches_jax():
    rng = np.random.default_rng(6)
    data = rng.standard_normal((30, 3, 2)).astype(np.float32)
    ids = rng.integers(0, 7, 30).astype(np.int32)
    _close(TG.segment_sum(_t(data), _t(ids), 8),
           jax.ops.segment_sum(jnp.asarray(data), ids, num_segments=8))
