"""The port's language models (``repro_torch.models.transformer``, with
MLA and MoE inside) against the JAX package's, for every LM entry of the
registry, on the CPU.

Each arch's smoke config runs twice: with parameters and compute in
float32, and in its own bfloat16. Inputs come from
``np.random.default_rng(seed)``; weights from the reference's
``lm_init(jax.random.key(k), cfg)``, carried over by
``repro_torch.convert.lm_params``. Tolerances: float32 logits and losses
within rtol 1e-4, atol 1e-5; float32 gradients (every parameter)
within rtol 1e-3, atol 1e-5; bfloat16 within the reference's own 5e-2
(``tests/test_archs.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.registry import ARCHS
from repro_torch.models import transformer as TT

F32 = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
LM_ARCHS = [a for a, s in ARCHS.items() if s.family == "lm"]
# the reference, jitted whole (op-by-op dispatch is slower on the CPU)
J_INIT = jax.jit(JT.lm_init, static_argnums=1)
J_LOGITS = jax.jit(JT.lm_logits, static_argnums=1)
J_LOSS = jax.jit(JT.lm_loss, static_argnums=1)
J_STEP = jax.jit(JT.lm_decode_step, static_argnums=1)


def _n(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _pair(arch: str, f32: bool):
    """(reference cfg, port cfg, reference params, port LM)."""
    jcfg, tcfg = J_ARCHS[arch].smoke_config, ARCHS[arch].smoke_config
    if f32:
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.float32,
                                   compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, param_dtype=torch.float32,
                                   compute_dtype=torch.float32)
    jp = J_INIT(jax.random.key(LM_ARCHS.index(arch)), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, convert.lm_params(tree, tcfg, device="cpu")


def _batch(cfg, b=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_logits_f32(arch):
    jcfg, tcfg, jp, tm = _pair(arch, True)
    toks = _batch(jcfg)["tokens"]
    with torch.no_grad():
        got = TT.lm_logits(tm, tcfg, torch.from_numpy(toks))
    assert got.shape == (2, 16, tcfg.vocab)
    np.testing.assert_allclose(_n(got), _n(J_LOGITS(jp, jcfg, toks)),
                               **F32)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_every_gradient_f32(arch):
    """The loss (with the MTP term for DeepSeek) and the gradient of
    every parameter: ``torch.autograd`` against ``jax.grad``."""
    jcfg, tcfg, jp, tm = _pair(arch, True)
    batch = _batch(jcfg, seed=1)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, batch)))(jp)
    names, params = zip(*tm.named_parameters())
    loss = TT.lm_loss(tm, tcfg, _torch(batch))
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(want_loss), **F32)
    want = convert.flatten_params(jax.tree_util.tree_map(np.asarray, want),
                                  stacked=("layers",))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(_n(g), want[name], err_msg=name, **GRAD)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_logits_and_loss_bf16(arch):
    """The smoke config's own bfloat16 params and compute."""
    jcfg, tcfg, jp, tm = _pair(arch, False)
    assert tm.embed.dtype == torch.bfloat16
    batch = _batch(jcfg, seed=3)
    with torch.no_grad():
        got = TT.lm_logits(tm, tcfg, torch.from_numpy(batch["tokens"]))
        loss = TT.lm_loss(tm, tcfg, _torch(batch))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_n(got), _n(J_LOGITS(jp, jcfg,
                                                      batch["tokens"])),
                               **BF16)
    np.testing.assert_allclose(float(loss),
                               float(J_LOSS(jp, jcfg, batch)), **BF16)


def test_remat_changes_no_gradient():
    """``cfg.remat`` recomputes each layer in the backward pass: the same
    loss and gradients as without it."""
    _, tcfg, _, tm = _pair("deepseek-v3-671b", True)
    batch = _torch(_batch(tcfg, seed=5))
    params = list(tm.parameters())
    res = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        loss = TT.lm_loss(tm, cfg, batch)
        res.append((loss, torch.autograd.grad(loss, params,
                                               materialize_grads=True)))
    assert torch.equal(res[0][0], res[1][0])
    for a, b in zip(res[0][1], res[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_xent(masked):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    want = JT._xent(logits, targets, mask)
    got = TT._xent(torch.from_numpy(logits), torch.from_numpy(targets),
                   None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), **F32)
