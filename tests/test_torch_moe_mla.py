"""The port's MoE and MLA (``repro_torch.models.moe``, ``mla``) against
the JAX package's, on the CPU.

Inputs come from ``np.random.default_rng(seed)``; weights from the
reference's ``*_init(jax.random.key(k), ...)``, carried over by
``repro_torch.convert.load_params``. Tolerances: float32 outputs within
rtol 1e-4, atol 1e-5; float32 gradients within rtol 1e-3, atol 1e-5;
integer lanes (expert indices, dispatch order and slots) bit for bit.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as JA
from repro.models import moe as JM
from repro_torch import convert
from repro_torch.models import mla as TA
from repro_torch.models import moe as TM

F32 = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _n(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol=F32):
    np.testing.assert_allclose(_n(got), np.asarray(want, np.float32), **tol)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _port(module_cls, tree, *args):
    """The port module ``module_cls(None, *args)`` with the reference
    tree's weights."""
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return convert.load_params(module_cls(None, *args, device="meta"), tree,
                               "cpu")


# ---------------------------------------------------------------- moe
def _moe(capacity_factor=8.0, n_shared=1, groups=1, seed=0):
    kw = dict(n_experts=8, top_k=2, d_ff_expert=16, n_shared=n_shared,
              capacity_factor=capacity_factor, dispatch_groups=groups)
    jcfg, tcfg = JM.MoEConfig(**kw), TM.MoEConfig(**kw)
    jp = JM.moe_init(jax.random.key(seed), 32, jcfg, jnp.float32)
    return jcfg, tcfg, jp, _port(TM.MoE, jp, 32, tcfg, torch.float32)


def test_route_indices_bit_for_bit():
    jcfg, tcfg, jp, tp = _moe()
    flat = _randn(np.random.default_rng(12), 40, 32)
    j_idx, j_w = JM._route(jp, jcfg, flat)
    t_idx, t_w = TM._route(tp, tcfg, _t(flat))
    np.testing.assert_array_equal(_n(t_idx), np.asarray(j_idx))
    _close(t_w, j_w)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.5])
def test_dispatch_slots_bit_for_bit(capacity_factor):
    """The stable sort by expert, each pair's slot (dropped pairs at
    ``E*C``) and the filled buffer equal the reference's sort-based
    dispatch (``_local_sort_dispatch``, the same steps) on the same
    routing; capacity 0.5 drops pairs."""
    jcfg, tcfg, jp, tp = _moe(capacity_factor)
    flat = _randn(np.random.default_rng(13), 32, 32)
    top_idx, _ = JM._route(jp, jcfg, flat)
    cap = TM.capacity(tcfg, 32)
    pair_e = np.asarray(top_idx).reshape(-1)
    pair_t = np.repeat(np.arange(32), 2)
    j_buf, j_order, j_slot = JM._local_sort_dispatch(
        flat[pair_t], jnp.asarray(pair_e), 8, cap)
    pt, slot, order = TM._dispatch_slots(_t(np.asarray(top_idx)), cap, 8)
    np.testing.assert_array_equal(_n(order), np.asarray(j_order))
    np.testing.assert_array_equal(_n(slot), np.asarray(j_slot))
    np.testing.assert_array_equal(_n(pt), pair_t[np.asarray(j_order)])
    buf = torch.zeros(8 * cap + 1, 32).index_put((slot,), _t(flat)[pt])
    np.testing.assert_array_equal(_n(buf[:-1]), np.asarray(j_buf))
    dropped = int((_n(slot) == 8 * cap).sum())
    assert dropped == 0 if capacity_factor == 8.0 else dropped > 0


@pytest.mark.parametrize("shared", [0.0, 3.0])
def test_route_and_slots_at_published_widths(shared):
    """DeepSeek-V3's published router (d 7168, 256 experts, top-8,
    capacity 1.25) from the reference's init, on 128 RMS-normalised
    hidden states with a component of size ``shared`` common to every
    token: ``top_idx`` and every dispatch slot bit for bit, ``top_w`` in
    f32, and the same share of (token, expert) pairs dropped at
    capacity. Prints both packages' dropped share."""
    from repro.configs.deepseek_v3_671b import FULL as J_FULL
    from repro.models.layers import dense_init
    from repro_torch.configs.deepseek_v3_671b import FULL as T_FULL
    jcfg, tcfg = J_FULL.moe, T_FULL.moe
    d, e, k, t = J_FULL.d_model, jcfg.n_experts, jcfg.top_k, 128
    jp = {"router": dense_init(jax.random.key(5), d, e, jnp.float32),
          "router_bias": jnp.zeros((e,), jnp.float32)}
    tp = types.SimpleNamespace(
        router=types.SimpleNamespace(w=_t(jp["router"]["w"])),
        router_bias=torch.zeros(e))
    rng = np.random.default_rng(18)
    h = shared * _randn(rng, 1, d) + _randn(rng, t, d)
    h = h / np.sqrt((h * h).mean(-1, keepdims=True))
    j_idx, j_w = JM._route(jp, jcfg, h)
    t_idx, t_w = TM._route(tp, tcfg, _t(h))
    np.testing.assert_array_equal(_n(t_idx), np.asarray(j_idx))
    _close(t_w, j_w)
    cap = TM.capacity(tcfg, t)
    assert cap == int(max(k, round(t * k / e * jcfg.capacity_factor)))
    pair_t = np.repeat(np.arange(t), k)
    _, j_order, j_slot = JM._local_sort_dispatch(
        h[pair_t], jnp.asarray(j_idx).reshape(-1), e, cap)
    pt, slot, order = TM._dispatch_slots(t_idx, cap, e)
    np.testing.assert_array_equal(_n(order), np.asarray(j_order))
    np.testing.assert_array_equal(_n(slot), np.asarray(j_slot))
    j_drop = float((np.asarray(j_slot) == e * cap).mean())
    t_drop = float((slot == e * cap).float().mean())
    print(f"shared {shared}: capacity {cap}, dropped share "
          f"reference {j_drop:.4f}, port {t_drop:.4f}")
    assert t_drop == j_drop


@pytest.mark.parametrize("capacity_factor,n_shared,groups", [
    (8.0, 1, 1), (0.5, 1, 1), (1.25, 0, 2), (0.5, 1, 4)])
def test_moe_apply(capacity_factor, n_shared, groups):
    jcfg, tcfg, jp, tp = _moe(capacity_factor, n_shared, groups, seed=1)
    x = _randn(np.random.default_rng(14), 2, 16, 32)
    _close(TM.moe_apply(tp, tcfg, _t(x)), JM.moe_apply(jp, jcfg, x))


def test_router_load_and_bias_update():
    jcfg, tcfg, jp, tp = _moe(seed=2)
    x = _randn(np.random.default_rng(15), 2, 8, 32)
    j_load = JM.router_load(jp, jcfg, x)
    t_load = TM.router_load(tp, tcfg, _t(x))
    _close(t_load, j_load)
    assert abs(float(t_load.sum()) - 1.0) < 1e-6
    jp2 = JM.update_router_bias(jp, jcfg, j_load)
    assert TM.update_router_bias(tp, tcfg, t_load) is tp
    np.testing.assert_array_equal(_n(tp.router_bias),
                                  np.asarray(jp2["router_bias"]))


# ---------------------------------------------------------------- mla
def _mla(seed=0):
    kw = dict(d_model=32, n_heads=4, d_c=16, d_cq=24, d_nope=8, d_rope=4,
              d_v=8)
    jcfg, tcfg = JA.MLAConfig(**kw), TA.MLAConfig(**kw)
    jp = JA.mla_init(jax.random.key(seed), jcfg, jnp.float32)
    return jcfg, tcfg, jp, _port(TA.MLA, jp, tcfg, torch.float32)


@pytest.mark.parametrize("s,chunk", [(12, 5), (12, 4), (7, 1024)])
def test_mla_train_apply(s, chunk):
    jcfg, tcfg, jp, tp = _mla()
    x = _randn(np.random.default_rng(16), 2, s, 32)
    pos = np.arange(s, dtype=np.int32)
    _close(TA.mla_train_apply(tp, tcfg, _t(x), _t(pos), chunk=chunk),
           JA.mla_train_apply(jp, jcfg, x, jnp.asarray(pos), chunk=chunk))


def test_mla_train_apply_gradients():
    jcfg, tcfg, jp, tp = _mla(seed=3)
    x = _randn(np.random.default_rng(17), 2, 10, 32)
    pos = jnp.arange(10)
    want = jax.grad(lambda p: JA.mla_train_apply(p, jcfg, x, pos,
                                                 chunk=4).sum())(jp)
    TA.mla_train_apply(tp, tcfg, _t(x), torch.arange(10), chunk=4
                       ).sum().backward()
    want = convert.flatten_params(jax.tree_util.tree_map(np.asarray, want))
    for name, p in tp.named_parameters():
        _close(p.grad, want[name], GRAD)


def test_mla_decode_step_by_step():
    jcfg, tcfg, jp, tp = _mla(seed=1)
    rng = np.random.default_rng(18)
    jc = JA.mla_init_cache(jcfg, 2, 8, jnp.float32)
    tc = TA.mla_init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    for step in range(6):
        x = _randn(rng, 2, 1, 32)
        want, jc = JA.mla_decode_apply(jp, jcfg, x, jc)
        got, tc = TA.mla_decode_apply(tp, tcfg, _t(x), tc)
        _close(got, want)
        _close(tc[0], jc[0])
        _close(tc[1], jc[1])
        assert tc[2] == int(jc[2]) == step + 1


def test_mla_decode_continues_the_prefill():
    """Decoding after the prompt gives the causal prefill's last rows
    (the absorbed form and the expanded form agree)."""
    _, tcfg, _, tp = _mla(seed=2)
    x = torch.from_numpy(_randn(np.random.default_rng(19), 2, 6, 32))
    full = TA.mla_train_apply(tp, tcfg, x, torch.arange(6), chunk=4)
    cache = TA.mla_init_cache(tcfg, 2, 6, torch.float32, device="cpu")
    steps = []
    for i in range(6):
        y, cache = TA.mla_decode_apply(tp, tcfg, x[:, i:i + 1], cache)
        steps.append(y)
    _close(torch.cat(steps, 1), full.detach())

