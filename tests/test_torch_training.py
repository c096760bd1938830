"""The port's training layer (``repro_torch.data.lm_data``,
``repro_torch.training``, ``convert.lm_tree`` / ``opt_tree``) against
the JAX package's, on the CPU, on the same numpy inputs.

Tolerances: token batches and DIN batches bit for bit; the schedule
within rtol 6e-7 at every step (about 8 float32 ulps: the reference's
own jitted and op-by-op evaluations differ by up to 8 ulps, 5.4e-7,
because XLA fuses the arithmetic and a one-ulp change of ``cos`` grows
up to 4.5x through ``0.1 + 0.9 * (1 + cos) / 2`` late in the decay);
``global_norm`` and AdamW with float32 state within rtol 1e-6, atol
1e-6 of the leaf's largest |value| (a lane where ``b1 * m + (1 - b1) *
g`` cancels keeps the absolute rounding error of its terms, and XLA
rounds that sum otherwise than eager PyTorch); with
bfloat16 params and state within one bfloat16 ulp of the reference's
value, the differing lanes counted (at most 1 %); checkpoints bit for
bit in both directions, and the same bytes on disk. Each case of
``tests/test_training.py`` has its port twin here.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import din as J_DIN
from repro.configs.registry import ARCHS as J_ARCHS
from repro.data import lm_data as JD
from repro.models import transformer as JT
from repro.training import checkpoint as JC
from repro.training import optimizer as JO
from repro_torch import convert
from repro_torch.configs import din as T_DIN
from repro_torch.configs.registry import ARCHS
from repro_torch.data import lm_data as TD
from repro_torch.data.lm_data import LMStreamConfig, TokenStream
from repro_torch.models import transformer as TT
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, global_norm,
                                            schedule)

F32 = 1e-6


def _close(got, want, err_msg=""):
    """Within rtol ``F32`` and atol ``F32`` times the largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=F32,
                               atol=F32 * float(np.abs(want).max(initial=0)),
                               err_msg=err_msg)


def _bits(x) -> np.ndarray:
    """A tensor's or array's raw bits as unsigned integers."""
    if torch.is_tensor(x):
        x = x.detach().cpu().contiguous()
        x = x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[x.element_size()]).numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(f"u{a.dtype.itemsize}")


def _named(tree) -> dict:
    """A reference tree's leaves as ``{dotted path: numpy array}`` in
    JAX's flatten order."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def _tensor(a: np.ndarray) -> torch.Tensor:
    return convert._param_tensor(a).clone()


# ------------------------------------------------------------- lm_data
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_token_stream_batches_bit_identical(seed):
    """6 steps of both streams, then 3 more from ``from_state`` at step 3
    on both sides, for a full vocabulary and a tiny one (where the
    rejection loop runs)."""
    for vocab, doc in ((151936, 256), (64, 8)):
        kw = dict(vocab=vocab, batch=2, seq_len=32, seed=seed,
                  mean_doc_len=doc)
        j = JD.TokenStream(JD.LMStreamConfig(**kw))
        t = TD.TokenStream(TD.LMStreamConfig(**kw))
        straight = []
        for _ in range(6):
            jb, tb = j.next_batch(), t.next_batch()
            assert t.state() == j.state()
            for k in ("tokens", "targets"):
                assert tb[k].dtype == jb[k].dtype == np.int32
                np.testing.assert_array_equal(tb[k], jb[k])
            straight.append(tb)
        j = JD.TokenStream.from_state(j.cfg, {"seed": seed, "step": 3})
        t = TD.TokenStream.from_state(t.cfg, {"seed": seed, "step": 3})
        for want in straight[3:]:
            jb, tb = j.next_batch(), t.next_batch()
            for k in ("tokens", "targets"):
                np.testing.assert_array_equal(tb[k], jb[k])
                np.testing.assert_array_equal(tb[k], want[k])


@pytest.mark.parametrize("step", [0, 5])
def test_din_synthetic_batch_bit_identical(step):
    for jcfg, tcfg in ((J_DIN.SMOKE, T_DIN.SMOKE), (J_DIN.FULL, T_DIN.FULL)):
        want = JD.din_synthetic_batch(jcfg, 16, seed=2, step=step)
        got = TD.din_synthetic_batch(tcfg, 16, seed=2, step=step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ----------------------------------------------------------- optimizer
SCHEDULE_RTOL = 6e-7


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 37), (100, 10_000)])
def test_schedule_equals_reference_every_step(warmup, total):
    """float32 on both sides, against the reference jitted (as its train
    step runs it) and op by op, within ``SCHEDULE_RTOL``."""
    jcfg = JO.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    tcfg = AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    steps = np.arange(total + 1, dtype=np.int32)
    ref = jax.vmap(lambda s: JO.schedule(jcfg, s))
    got = schedule(tcfg, torch.from_numpy(steps)).numpy()
    for want in (np.asarray(jax.jit(ref)(steps)), np.asarray(ref(steps))):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=SCHEDULE_RTOL, atol=0)
    assert got[0] == 0.0 and got[-1] == np.float32(3e-4) * np.float32(0.1)


def _opt_tree(rng, dtype=np.float32):
    """A reference-shaped tree with 2-D, 1-D and 0-d leaves."""
    return {"w": rng.standard_normal((8, 16)).astype(dtype),
            "b": rng.standard_normal(16).astype(dtype),
            "s": np.asarray(rng.standard_normal(), dtype),
            "blocks": [{"k": rng.standard_normal((3, 4, 5)).astype(dtype)},
                       {"k": rng.standard_normal((2, 5)).astype(dtype)}]}


def _adamw_pair(n_steps, jcfg, tcfg, dtype, none_grad=None, seed=0):
    """``n_steps`` updates of both packages on the same params and grads
    (a fresh draw a step). Returns ({name: (port, reference)} for params,
    m and v, the two global norms of the last grads)."""
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tree = _opt_tree(rng)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    tp = {n: _tensor(a) for n, a in _named(jp).items()}
    js, ts = JO.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    upd = jax.jit(lambda p, g, s: JO.adamw_update(p, g, s, jcfg))
    for _ in range(n_steps):
        g = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape) * 0.3, jdt), jp)
        if none_grad is not None:
            g[none_grad] = jnp.zeros_like(g[none_grad])
        tg = {n: _tensor(a) for n, a in _named(g).items()}
        if none_grad is not None:
            tg[none_grad] = None
        norms = (float(global_norm(tg)), float(JO.global_norm(g)))
        jp, js = upd(jp, g, js)
        adamw_update(tp, tg, ts, tcfg)
    assert int(ts["step"]) == int(js["step"]) == n_steps
    out = {}
    for part, jtree, tmap in (("p", jp, tp), ("m", js["m"], ts["m"]),
                              ("v", js["v"], ts["v"])):
        for n, a in _named(jtree).items():
            out[f"{part}:{n}"] = (tmap[n], a)
    return out, norms


@pytest.mark.parametrize("n_steps", [1, 3])
def test_global_norm_and_adamw_f32(n_steps):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    out, (gn, want_gn) = _adamw_pair(n_steps, JO.AdamWConfig(**cfg),
                                     AdamWConfig(**cfg), "f32")
    np.testing.assert_allclose(gn, want_gn, rtol=F32)
    for name, (got, want) in out.items():
        assert got.dtype == torch.float32
        _close(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adamw_bf16_params_and_state(n_steps):
    """bfloat16 params and moments: every lane within one bfloat16 ulp of
    the reference's (the f32 math rounds once; a lane whose f32 value
    lies a hair from a rounding boundary may round the other way)."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    out, _ = _adamw_pair(n_steps, JO.AdamWConfig(**cfg,
                                                  state_dtype=jnp.bfloat16),
                         AdamWConfig(**cfg, state_dtype=torch.bfloat16),
                         "bf16", seed=1)
    lanes = differ = 0
    for name, (got, want) in out.items():
        assert got.dtype == torch.bfloat16, name
        g, w = got.float().numpy(), np.asarray(want, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= ulp), name
        lanes += g.size
        differ += int((g != w).sum())
    assert differ <= 0.01 * lanes, (differ, lanes)


def test_decay_applies_to_matrices_only():
    """Zero gradients: a 2-D leaf shrinks by lr * wd * p, 1-D and 0-d
    leaves stay as they are, in both packages; ``decay`` names the
    decayed leaves instead."""
    cfg = dict(lr=0.1, warmup_steps=0, total_steps=10, weight_decay=0.5)
    rng = np.random.default_rng(2)
    tree = _opt_tree(rng)
    jp = jax.tree.map(jnp.asarray, tree)
    js = JO.adamw_init(jp, JO.AdamWConfig(**cfg))
    jp2, _ = JO.adamw_update(jp, jax.tree.map(jnp.zeros_like, jp), js,
                             JO.AdamWConfig(**cfg))
    tp = {n: _tensor(a) for n, a in _named(jp).items()}
    ts = adamw_init(tp, AdamWConfig(**cfg))
    adamw_update(tp, {}, ts, AdamWConfig(**cfg))
    for n, want in _named(jp2).items():
        _close(tp[n].numpy(), want, err_msg=n)
        if _named(tree)[n].ndim < 2:
            np.testing.assert_array_equal(tp[n].numpy(), _named(jp)[n])
        else:
            assert not np.array_equal(tp[n].numpy(), _named(jp)[n])
    tp = {n: _tensor(a) for n, a in _named(jp).items()}
    adamw_update(tp, {}, adamw_init(tp, AdamWConfig(**cfg)),
                 AdamWConfig(**cfg), decay={"b"})
    assert not np.array_equal(tp["b"].numpy(), tree["b"])
    np.testing.assert_array_equal(tp["w"].numpy(), tree["w"])


def test_none_grad_is_a_zero_gradient():
    """A ``None`` gradient (autograd's answer for a parameter reached only
    through indices) moves the leaf and its moments exactly as the
    reference's zero gradient does, and keeps its state."""
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    out, (gn, want_gn) = _adamw_pair(3, JO.AdamWConfig(**cfg),
                                     AdamWConfig(**cfg), "f32",
                                     none_grad="b", seed=3)
    np.testing.assert_allclose(gn, want_gn, rtol=F32)
    for name, (got, want) in out.items():
        _close(got.numpy(), want, err_msg=name)
    for part in ("m", "v"):
        np.testing.assert_array_equal(out[f"{part}:b"][0].numpy(), 0.0)


def test_decayed_names_the_reference_leaves_of_two_or_more_dims():
    """An LM's per-layer norms are slices of stacked [L, d] leaves in the
    reference, which decays them; ``ln_final`` and the MTP block's norms
    are not stacked."""
    for arch in ("qwen3-0.6b", "deepseek-v3-671b"):
        jcfg = J_ARCHS[arch].smoke_config
        shapes = jax.eval_shape(lambda: JT.lm_init(jax.random.key(0), jcfg))
        flat = convert.flatten_params(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), shapes),
            stacked=("layers",))
        model = TT.LM(None, ARCHS[arch].smoke_config, device="meta")
        ndim = {k: (a.ndim + 1 if k.startswith("layers.") else a.ndim)
                for k, a in flat.items()}
        assert convert.decayed(model) == {k for k, d in ndim.items()
                                          if d >= 2}
        assert "layers.0.ln_attn" in convert.decayed(model)
        assert "ln_final" not in convert.decayed(model)


# --------------------------- the port's cases of tests/test_training.py
def small_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal((4, 8))).float(),
            "b": [torch.from_numpy(rng.standard_normal(3)).bfloat16(),
                  torch.from_numpy(rng.integers(0, 5, 4)).int()]}


def test_checkpoint_roundtrip(tmp_path):
    tree = small_tree()
    checkpoint.save(tmp_path, 7, tree, extra={"foo": 1})
    out, step, extra = checkpoint.restore(tmp_path, tree, device="cpu")
    assert step == 7 and extra == {"foo": 1}
    got, _ = checkpoint.tree_flatten(out)
    for a, b in zip(checkpoint.tree_flatten(tree)[0], got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_checkpoint_keeps_latest_and_gc(tmp_path):
    tree = small_tree()
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(tmp_path, s, tree, keep=2)
    assert checkpoint.latest_step(tmp_path) == 5
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [4, 5]


def test_checkpoint_atomicity_partial_tmp(tmp_path):
    tree = small_tree()
    checkpoint.save(tmp_path, 1, tree)
    # a crashed writer leaves a tmp dir; restore must ignore it
    (tmp_path / "step_000000002.tmp-dead").mkdir()
    assert checkpoint.latest_step(tmp_path) == 1
    out, step, _ = checkpoint.restore(tmp_path, tree, device="cpu")
    assert step == 1
    checkpoint.save(tmp_path, 3, tree)
    assert not list(tmp_path.glob("*.tmp-*"))


def test_checkpoint_rejects_another_tree(tmp_path):
    tree = small_tree()
    checkpoint.save(tmp_path, 1, tree)
    with pytest.raises(ValueError, match="leaf count"):
        checkpoint.restore(tmp_path, {"a": tree["a"]}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(tmp_path, {**tree, "a": torch.zeros(2, 2)},
                           device="cpu")


def test_adamw_reduces_loss():
    rng = np.random.default_rng(0)
    w_true = torch.from_numpy(rng.standard_normal((8, 1))).float()
    x = torch.from_numpy(rng.standard_normal((64, 8))).float()
    y = x @ w_true
    params = {"w": torch.zeros((8, 1), requires_grad=True)}
    cfg = AdamWConfig(lr=5e-2, warmup_steps=1, total_steps=100,
                      weight_decay=0.0)
    state = adamw_init(params, cfg)

    def loss_fn(p):
        return torch.mean((x @ p["w"] - y) ** 2)

    l0 = loss_fn(params).item()
    for _ in range(60):
        params["w"].grad = None
        loss_fn(params).backward()
        adamw_update(params, {"w": params["w"].grad}, state, cfg)
    assert loss_fn(params).item() < 0.05 * l0


def test_adamw_bf16_state_mode():
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    # lr large enough that the delta survives bf16 rounding at 1.0
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, state_dtype=torch.bfloat16)
    state = adamw_init(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    g = {"w": torch.full((4, 4), 0.1, dtype=torch.bfloat16)}
    p2, s2 = adamw_update(params, g, state, cfg)
    assert p2["w"].dtype == torch.bfloat16
    assert not np.allclose(p2["w"].float().numpy(), 1.0)


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    assert float(schedule(cfg, 0)) == 0.0
    assert abs(float(schedule(cfg, 10)) - 1.0) < 1e-6
    assert float(schedule(cfg, 100)) <= 0.11


def test_token_stream_deterministic_resume():
    cfg = LMStreamConfig(vocab=128, batch=2, seq_len=16)
    s1 = TokenStream(cfg)
    batches = [s1.next_batch() for _ in range(5)]
    # resume from step 3
    s2 = TokenStream.from_state(cfg, {"seed": 0, "step": 3})
    b3 = s2.next_batch()
    np.testing.assert_array_equal(batches[3]["tokens"], b3["tokens"])


# ------------------------------------------ checkpoints across packages
def _qwen3_pair(state_dtype):
    """The qwen3 smoke (params, opt) tree in both packages: the
    reference's ``lm_init`` (bf16) and one ``adamw_update`` on random
    grads (moments in ``state_dtype``), carried over to the port."""
    jcfg = J_ARCHS["qwen3-0.6b"].smoke_config
    ocfg = JO.AdamWConfig(state_dtype=state_dtype, warmup_steps=0)
    jp = jax.jit(JT.lm_init, static_argnums=1)(jax.random.key(0), jcfg)
    rng = np.random.default_rng(4)
    g = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape),
                                           a.dtype), jp)
    jp, jopt = jax.jit(lambda p, g: JO.adamw_update(
        p, g, JO.adamw_init(p, ocfg), ocfg))(jp, g)
    model = convert.lm_params(jax.tree.map(np.asarray, jp),
                              ARCHS["qwen3-0.6b"].smoke_config, device="cpu")
    opt = convert.opt_state(jax.tree.map(np.asarray, jopt), model)
    return (jp, jopt), (convert.lm_tree(model), convert.opt_tree(opt, model))


STATE_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.mark.parametrize("state", list(STATE_DTYPES))
def test_reference_checkpoint_restores_in_the_port(tmp_path, state):
    jtree, ttree = _qwen3_pair(STATE_DTYPES[state])
    JC.save(tmp_path, 5, jtree, extra={"stream": {"seed": 0, "step": 5}})
    out, step, extra = checkpoint.restore(tmp_path, ttree, device="cpu")
    assert step == 5 and extra == {"stream": {"seed": 0, "step": 5}}
    got, _ = checkpoint.tree_flatten(out)
    want = jax.tree.leaves(jtree)
    assert len(got) == len(want) == len(checkpoint.tree_flatten(ttree)[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("state", list(STATE_DTYPES))
def test_port_checkpoint_restores_in_the_reference(tmp_path, state):
    jtree, ttree = _qwen3_pair(STATE_DTYPES[state])
    checkpoint.save(tmp_path, 5, ttree, extra={"loss": 1.5})
    out, step, extra = JC.restore(tmp_path, jtree)
    assert step == 5 and extra == {"loss": 1.5}
    for g, w in zip(jax.tree.leaves(out), checkpoint.tree_flatten(ttree)[0]):
        assert str(g.dtype) == str(w.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("state", list(STATE_DTYPES))
def test_both_packages_write_the_same_checkpoint(tmp_path, state):
    """The same manifest but its clock (the tree descriptor in JAX's
    notation included) and the same bytes in every ``a<i>``."""
    jtree, ttree = _qwen3_pair(STATE_DTYPES[state])
    JC.save(tmp_path / "ref", 3, jtree, extra={"x": 1})
    checkpoint.save(tmp_path / "port", 3, ttree, extra={"x": 1})
    want, got = (json.loads((tmp_path / w / "step_000000003" /
                             "manifest.json").read_text())
                 for w in ("ref", "port"))
    want.pop("time"), got.pop("time")
    assert got == want
    assert "bfloat16" in got["dtypes"]
    ref = np.load(tmp_path / "ref" / "step_000000003" / "arrays.npz")
    port = np.load(tmp_path / "port" / "step_000000003" / "arrays.npz")
    assert sorted(ref.files) == sorted(port.files)
    for k in ref.files:
        assert port[k].dtype == ref[k].dtype, k
        assert port[k].tobytes() == ref[k].tobytes(), k


def test_specs_are_written_as_the_reference_writes_them(tmp_path):
    tree = {"w": np.zeros((2, 3), np.float32), "b": [np.zeros(3), None]}
    specs = {"w": "P('data', None)", "b": [None, None]}
    checkpoint.save(tmp_path / "port", 1, tree, specs=specs)
    JC.save(tmp_path / "ref", 1, tree, specs=specs)
    got, want = (json.loads((tmp_path / w / "step_000000001" /
                             "manifest.json").read_text())
                 for w in ("port", "ref"))
    assert got["specs"] == want["specs"] == ["None", "P('data', None)"]
    assert got["treedef"] == want["treedef"]


# --------------------------------------------------------------- convert
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b"])
def test_lm_tree_round_trip(arch):
    """``lm_tree`` is the reference's tree (leaf for leaf, in JAX's order,
    layers and experts stacked), and ``lm_params`` of it gives the same
    model bit for bit; ``ref_order`` walks the reference's order."""
    jcfg, tcfg = J_ARCHS[arch].smoke_config, ARCHS[arch].smoke_config
    jp = jax.jit(JT.lm_init, static_argnums=1)(jax.random.key(2), jcfg)
    model = convert.lm_params(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    tree = convert.lm_tree(model)
    got, treedef = checkpoint.tree_flatten(tree)
    want = _named(jp)
    assert str(treedef) == str(jax.tree.structure(jp))
    assert len(got) == len(want)
    for g, (name, w) in zip(got, want.items()):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)
    back = convert.lm_params(tree, tcfg, device="cpu")
    for (n, a), (m, b) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert n == m and a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=n)
    order = [n.split(".") for n in convert.ref_order(model)]
    stacked = [[p[0], *p[2:]] if p[0] == "layers" else p for p in order]
    names = list(dict.fromkeys(".".join(p) for p in stacked))
    assert names == list(want)


def test_opt_tree_round_trip():
    jtree, ttree = _qwen3_pair(jnp.float32)
    model = convert.lm_params(ttree[0], ARCHS["qwen3-0.6b"].smoke_config,
                              device="cpu")
    state = convert.opt_state(ttree[1], model)
    assert set(state["m"]) == set(dict(model.named_parameters()))
    again = convert.opt_tree(state, model)
    for g, w in zip(checkpoint.tree_flatten(again)[0],
                    jax.tree.leaves(jtree[1])):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_gnn_tree_is_the_reference_tree():
    from repro.configs.registry import ARCHS as JA
    from repro.models import gnn as JG
    jcfg = dataclasses.replace(JA["gin-tu"].smoke_config)
    jp = JG.gnn_init(jax.random.key(1), jcfg)
    model = convert.gnn_params(jax.tree.map(np.asarray, jp),
                               ARCHS["gin-tu"].smoke_config, device="cpu")
    got, treedef = checkpoint.tree_flatten(convert.gnn_tree(model))
    assert str(treedef) == str(jax.tree.structure(jp))
    for g, w in zip(got, jax.tree.leaves(jp)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
