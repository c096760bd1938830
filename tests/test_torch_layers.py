"""The port's shared layers (``repro_torch.models.layers``: norms, RoPE,
attention with and without a KV cache, MLPs) against the JAX package's,
on the CPU.

Inputs come from ``np.random.default_rng(seed)``; weights from the
reference's ``*_init(jax.random.key(k), ...)``, carried over by
``repro_torch.convert.load_params``. Tolerances: float32 outputs within
rtol 1e-4, atol 1e-5; float32 gradients within rtol 1e-3, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch import convert
from repro_torch.models import layers as TL

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


# ---------------------------------------------------------------- norms
def test_rms_norm_and_layer_norm():
    rng = np.random.default_rng(0)
    x, scale, bias = _randn(rng, 3, 5, 24), _randn(rng, 24), _randn(rng, 24)
    _close(TL.rms_norm(_t(x), _t(scale)), JL.rms_norm(x, scale))
    _close(TL.layer_norm(_t(x), _t(scale), _t(bias)),
           JL.layer_norm(x, scale, bias))


@pytest.mark.parametrize("shape", [(2, 7, 3, 16), (2, 7, 24)])
def test_apply_rope_at_odd_positions(shape):
    rng = np.random.default_rng(1)
    x = _randn(rng, *shape)
    pos = np.array([3, 5, 17, 33, 101, 127, 199], np.int32)
    _close(TL.apply_rope(_t(x), _t(pos), 1e4),
           JL.apply_rope(x, jnp.asarray(pos), 1e4))
    _close(TL.apply_rope(_t(x), _t(pos), 1e6),
           JL.apply_rope(x, jnp.asarray(pos), 1e6))


def test_rope_freqs():
    _close(TL.rope_freqs(16, 9, device="cpu"), JL.rope_freqs(16, 9))


# ---------------------------------------------------------------- attention
def _qkv(seed, b=2, s=5, t=23, h=4, hk=2, d=16):
    rng = np.random.default_rng(seed)
    return _randn(rng, b, s, h, d), _randn(rng, b, t, hk, d), \
        _randn(rng, b, t, hk, d)


@pytest.mark.parametrize("causal,q_offset", [(True, None), (True, 4),
                                              (False, None)])
def test_sdpa(causal, q_offset):
    q, k, v = _qkv(2)
    _close(TL._sdpa(_t(q), _t(k), _t(v), causal, q_offset),
           JL._sdpa(q, k, v, causal, q_offset))


@pytest.mark.parametrize("causal,q_offset,valid_len,chunk", [
    (True, 0, None, 8), (True, 7, 19, 8), (False, 0, 11, 5),
    (True, 18, None, 32)])
def test_chunked_sdpa(causal, q_offset, valid_len, chunk):
    q, k, v = _qkv(3)
    kw = dict(causal=causal, q_offset=q_offset, chunk=chunk,
              valid_len=valid_len)
    _close(TL.chunked_sdpa(_t(q), _t(k), _t(v), **kw),
           JL.chunked_sdpa(q, k, v, **kw))


def test_chunked_sdpa_gradients_through_the_recomputed_chunks():
    q, k, v = _qkv(4, s=9, t=21)
    kw = dict(causal=True, q_offset=12, chunk=8, valid_len=20)
    w = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(lambda q, k, v: (JL.chunked_sdpa(q, k, v, **kw)
                                     * w).sum(), argnums=(0, 1, 2))(q, k, v)
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    (TL.chunked_sdpa(*ts, **kw) * _t(w)).sum().backward()
    for got, ref in zip(ts, want):
        _close(got.grad, ref, GRAD)


def test_masked_sdpa():
    q, k, v = _qkv(6)
    mask = np.random.default_rng(7).random((5, 23)) < 0.5
    mask[:, 0] = True
    _close(TL._masked_sdpa(_t(q), _t(k), _t(v), _t(mask)),
           JL._masked_sdpa(q, k, v, jnp.asarray(mask)))


def _attn_cfg(**kw):
    base = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
    return JL.AttnConfig(**base, **kw), TL.AttnConfig(**base, **kw)


@pytest.mark.parametrize("kw,s", [
    ({}, 6), ({"qkv_bias": True, "qk_norm": True}, 6),
    ({"attn_chunk": 8, "qk_norm": True}, 20)])
def test_attn_apply_without_cache(kw, s):
    jcfg, tcfg = _attn_cfg(**kw)
    jp = JL.attn_init(jax.random.key(1), jcfg, jnp.float32)
    tp = _port(TL.Attention, jp, tcfg, torch.float32)
    x = _randn(np.random.default_rng(8), 2, s, 32)
    pos = np.arange(3, 3 + s, dtype=np.int32)
    want, _ = JL.attn_apply(jp, jcfg, x, jnp.asarray(pos))
    got, cache = TL.attn_apply(tp, tcfg, _t(x), _t(pos))
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("kw", [{}, {"qkv_bias": True, "qk_norm": True}])
def test_attn_apply_with_cache_writes_in_place(kw):
    """A 5-token prefill into the cache, then three one-token steps:
    every output and the whole cache equal the reference's after each."""
    jcfg, tcfg = _attn_cfg(**kw)
    jp = JL.attn_init(jax.random.key(2), jcfg, jnp.float32)
    tp = _port(TL.Attention, jp, tcfg, torch.float32)
    rng = np.random.default_rng(9)
    b, s_max = 2, 12
    jc = (jnp.zeros((b, s_max, 2, 8)), jnp.zeros((b, s_max, 2, 8)), 0)
    tk, tv = torch.zeros(b, s_max, 2, 8), torch.zeros(b, s_max, 2, 8)
    length = 0
    for s in (5, 1, 1, 1):
        x = _randn(rng, b, s, 32)
        pos = np.arange(length, length + s, dtype=np.int32)
        want, jc = JL.attn_apply(jp, jcfg, x, jnp.asarray(pos), kv_cache=jc)
        got, (ck, cv, length) = TL.attn_apply(
            tp, tcfg, _t(x), _t(pos), kv_cache=(tk, tv, length))
        assert ck is tk and cv is tv and length == int(jc[2])
        _close(got, want)
        _close(tk, jc[0])
        _close(tv, jc[1])


# ---------------------------------------------------------------- mlp
def test_swiglu():
    jp = JL.swiglu_init(jax.random.key(3), 16, 40, jnp.float32)
    tp = _port(TL.SwiGLU, jp, 16, 40, torch.float32)
    x = _randn(np.random.default_rng(10), 3, 4, 16)
    _close(TL.swiglu_apply(tp, _t(x)), JL.swiglu_apply(jp, x))


def test_gelu_mlp_is_the_tanh_gelu():
    jp = JL.gelu_mlp_init(jax.random.key(4), 16, 40, jnp.float32)
    tp = _port(TL.GeluMLP, jp, 16, 40, torch.float32)
    x = 3 * _randn(np.random.default_rng(11), 3, 4, 16)
    got = TL.gelu_mlp_apply(tp, _t(x))
    _close(got, JL.gelu_mlp_apply(jp, x))
    h = x @ np.asarray(jp["wi"]["w"]) + np.asarray(jp["wi"]["b"])
    erf = torch.nn.functional.gelu(_t(h)) @ _t(np.asarray(jp["wo"]["w"])) \
        + _t(np.asarray(jp["wo"]["b"]))
    assert (erf - got).abs().max() > 1e-5   # not the exact-erf GELU
