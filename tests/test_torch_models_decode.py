"""Decoding in the port's language models (``lm_decode_step`` over the
KV or latent cache) against the JAX package's and against the port's
own prefill, for every LM entry of the registry, on the CPU.

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
def test_lm_decode_step_by_step_f32(arch):
    """Eight ``lm_decode_step``s (a 3-token first step, then single
    tokens): every step's logits equal the reference's, and the caches
    hold what the reference's hold."""
    jcfg, tcfg, jp, tm = _pair(arch, True)
    toks = _batch(jcfg, s=10, seed=2)["tokens"]
    jstate = JT.init_decode_state(jcfg, batch=2, s_max=12)
    tstate = TT.init_decode_state(tcfg, batch=2, s_max=12, device="cpu")
    spans = [(0, 3)] + [(i, i + 1) for i in range(3, 10)]
    with torch.no_grad():
        for lo, hi in spans:
            want, jstate = J_STEP(jp, jcfg, toks[:, lo:hi], jstate)
            got, tstate = TT.lm_decode_step(
                tm, tcfg, torch.from_numpy(toks[:, lo:hi]), tstate)
            np.testing.assert_allclose(_n(got), _n(want), **F32)
            assert tstate["length"] == int(jstate["length"]) == hi
    for got, want in zip(tstate["cache"][:2], jstate["cache"][:2]):
        np.testing.assert_allclose(_n(got), _n(want), **F32)


DENSE_ARCHS = [a for a in LM_ARCHS if ARCHS[a].smoke_config.moe is None]


@pytest.mark.parametrize("arch,f32", [(a, True) for a in LM_ARCHS]
                         + [(a, False) for a in DENSE_ARCHS])
def test_lm_decode_matches_prefill(arch, f32):
    """The port's own decode logits equal its teacher-forced forward
    logits (as ``tests/test_archs.py`` holds the reference's): every
    arch in float32 (rtol 1e-4, atol 1e-5), the dense ones also in their
    own bfloat16 (5e-2). A bfloat16 MoE is left out: there a near-tie
    of two experts' router scores can resolve one way in the prefill and
    the other in decode, in either package (next test)."""
    _, tcfg, _, tm = _pair(arch, f32)
    toks = torch.from_numpy(_batch(tcfg, s=8, seed=4)["tokens"])
    state = TT.init_decode_state(tcfg, batch=2, s_max=16, device="cpu")
    with torch.no_grad():
        full = TT.lm_logits(tm, tcfg, toks)
        outs = []
        for i in range(8):
            lg, state = TT.lm_decode_step(tm, tcfg, toks[:, i:i + 1], state)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(_n(torch.stack(outs, 1)), _n(full),
                               **(F32 if f32 else BF16))


def test_bf16_moe_decode_leaves_the_prefill_in_the_reference_too():
    """Pins the reason the bfloat16 MoE archs are left out above: the
    reference's own DeepSeek smoke model (key 3, tokens of seed 4)
    decodes logits more than 5e-2 away from its prefill's, where a
    router near-tie flips one expert."""
    jcfg = J_ARCHS["deepseek-v3-671b"].smoke_config
    jp = J_INIT(jax.random.key(3), jcfg)
    toks = _batch(jcfg, s=8, seed=4)["tokens"]
    full = _n(J_LOGITS(jp, jcfg, toks))
    state = JT.init_decode_state(jcfg, batch=2, s_max=16)
    outs = []
    for i in range(8):
        lg, state = J_STEP(jp, jcfg, toks[:, i:i + 1], state)
        outs.append(_n(lg[:, 0]))
    off = np.abs(np.stack(outs, 1) - full) > 5e-2 + 5e-2 * np.abs(full)
    assert off.any()
