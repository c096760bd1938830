"""The port's training step and driver (``repro_torch.launch.train``) and
the motif GCN example against the JAX package's, on the CPU.

The train step runs the qwen3-0.6b and deepseek-v3-671b smoke configs in
float32 with the reference's ``lm_init(key 0)`` weights carried over by
``convert.lm_params``: 5 steps of the reference's jitted
``value_and_grad`` + ``adamw_update`` (as its driver runs them) against
the port's ``train_step`` on the same ``TokenStream`` batches. The motif
GCN runs 20 steps of both examples' loops on the same weights and
inputs (motif counts equal exactly). Tolerances:

  * each step's loss within rtol 1e-5;
  * final weights within the sign-flip rule (``adam_rule``): a lane
    agrees within rtol 1e-5, atol 1e-6; AdamW's first steps move a
    weight by about ``lr * sign(g)``, so where a gradient near 0 comes
    out with the other sign, a lane may differ by up to ``2 * sum(lr) *
    (1.2 + wd * |w|)`` (1.2 bounds ``|m_hat| / sqrt(v_hat)`` for b1 0.9,
    b2 0.95) — at most 1 lane in 1000 may;
  * moments within 1e-4 of the leaf's largest |value|.

The driver's crash-and-resume run must end bit for bit where an
uninterrupted run ends, and either package must resume the other's
checkpoints.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.launch import train as J_TRAIN
from repro.models import gnn as JG
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro_torch import convert
from repro_torch.configs.registry import ARCHS
from repro_torch.data.lm_data import LMStreamConfig, TokenStream
from repro_torch.launch import train as T_TRAIN
from repro_torch.training import checkpoint
from repro_torch.training import optimizer as TO

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
AGREE = (1e-5, 1e-6)          # rtol, atol of an agreeing lane
FLIP_SHARE = 1e-3             # lanes allowed past AGREE
STEP_BOUND = 1.2              # |m_hat| / sqrt(v_hat) for b1 0.9, b2 0.95
MOMENT_ATOL = 1e-4            # of the leaf's largest |value|


def adam_rule(got: np.ndarray, want: np.ndarray, lr_sum: float,
              wd: float) -> tuple[int, float]:
    """(lanes past ``AGREE``, the largest of them over its bound; must
    be <= 1)."""
    d = np.abs(got.astype(np.float64) - want)
    past = d > AGREE[1] + AGREE[0] * np.abs(want)
    bound = 2 * lr_sum * (STEP_BOUND + wd * np.abs(want))
    return int(past.sum()), float((d[past] / bound[past]).max(initial=0))


def check_final(got: list, want: list, lr_sum: float, wd: float,
                what: str) -> int:
    """``got`` / ``want``: [(name, array)] in one order. Applies the rule
    to the whole model; returns the lanes past ``AGREE``."""
    lanes = flips = 0
    for (name, g), (wname, w) in zip(got, want, strict=True):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (name, wname)
        n, worst = adam_rule(g, w, lr_sum, wd)
        assert worst <= 1.0, f"{what} {name}: {n} lanes, worst {worst}"
        lanes, flips = lanes + g.size, flips + n
    assert flips <= FLIP_SHARE * lanes, f"{what}: {flips} of {lanes} lanes"
    return flips


def check_moments(got: list, want: list) -> None:
    for (name, g), (_, w) in zip(got, want, strict=True):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0,
                                   atol=MOMENT_ATOL * np.abs(w).max(
                                       initial=0), err_msg=name)


def _leaves(tree) -> list:
    """[(path, array)] of a tree of either package in JAX's order."""
    leaves, _ = checkpoint.tree_flatten(tree)
    paths = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda _: 0, tree, is_leaf=torch.is_tensor))[0]
    return [(jax.tree_util.keystr(p), (leaf.detach().float().numpy()
                                       if torch.is_tensor(leaf)
                                       else np.asarray(leaf, np.float32)))
            for (p, _), leaf in zip(paths, leaves)]


def _lr_sum(ocfg, steps: int) -> float:
    return float(sum(TO.schedule(ocfg, s) for s in range(1, steps + 1)))


# ------------------------------------------------------ the train step
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b"])
def test_train_step_matches_the_reference(arch):
    f32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32)
    jcfg = dataclasses.replace(J_ARCHS[arch].smoke_config, **f32)
    tcfg = dataclasses.replace(ARCHS[arch].smoke_config,
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    steps = 5
    kw = dict(lr=3e-4, total_steps=steps, warmup_steps=max(10, steps // 20))
    jo, to = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jp = jax.jit(JT.lm_init, static_argnums=1)(jax.random.key(0), jcfg)
    model = convert.lm_params(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    jopt = JO.adamw_init(jp, jo)
    topt = TO.adamw_init(convert.ref_order(model), to)

    @jax.jit
    def jstep(params, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda p: JT.lm_loss(p, jcfg, batch))(params)
        params, opt = JO.adamw_update(params, grads, opt, jo)
        return params, opt, loss

    stream = TokenStream(LMStreamConfig(vocab=tcfg.vocab, batch=2,
                                        seq_len=32))
    for _ in range(steps):
        batch = stream.next_batch()
        jp, jopt, jloss = jstep(jp, jopt, batch)
        loss = T_TRAIN.train_step(model, topt, {
            k: torch.from_numpy(v) for k, v in batch.items()}, tcfg, to)
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LOSS_RTOL)
    assert int(topt["step"]) == steps
    check_final(_leaves(convert.lm_tree(model)), _leaves(jp),
                _lr_sum(to, steps), to.weight_decay, arch)
    tree = convert.opt_tree(topt, model)
    for part in ("m", "v"):
        check_moments(_leaves(tree[part]), _leaves(jopt[part]))


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_motif_gcn_matches_the_reference():
    """Both examples: the same motif counts, bit for bit; then 20 steps of
    the GCN on the motif features from the reference's ``gnn_init(key
    0)`` weights."""
    ref, port = (_example("motif_features_gnn"),
                 _example("motif_features_gnn_torch"))
    feats, labels, base_x, ei = port.motif_task()
    data = ref.ba_labeled_graph(200, 3, 3, extra_edges=150, seed=1)
    tri = ref.Graph.from_edges(3, [(0, 1), (1, 2), (2, 0)], [0, 0, 0], 3)
    path = ref.Graph.from_edges(3, [(0, 1), (1, 2)], [0, 1, 0], 3)
    np.testing.assert_array_equal(feats, ref.motif_counts(data, [tri, path]))
    assert 0 < labels.sum() < len(labels)
    x = np.concatenate([base_x, feats], 1)
    cfg = port.gnn_config(x)
    jcfg = JG.GNNConfig(name="demo", kind="gcn", n_layers=2, d_in=x.shape[1],
                        d_hidden=16, n_classes=2)
    jp = JG.gnn_init(jax.random.key(0), jcfg)
    model = convert.gnn_params(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    ocfg = dataclasses.asdict(port.OCFG)
    assert ocfg.pop("state_dtype") == torch.float32
    jo = JO.AdamWConfig(**ocfg)
    opt = JO.adamw_init(jp, jo)
    xj, eij, lj = jnp.asarray(x), jnp.asarray(ei), jnp.asarray(labels)

    @jax.jit
    def step(params, opt):
        loss, g = jax.value_and_grad(
            lambda p: JG.gnn_loss(p, jcfg, xj, eij, lj))(params)
        params, opt = JO.adamw_update(params, g, opt, jo)
        return params, opt, loss

    want = []
    for _ in range(20):
        jp, opt, loss = step(jp, opt)
        want.append(float(loss))
    losses, acc = port.train(model, cfg, x, ei, labels, steps=20)
    np.testing.assert_allclose(losses.numpy(), want, rtol=LOSS_RTOL)
    assert 0.5 < acc <= 1.0
    check_final(_leaves(convert.gnn_tree(model)), _leaves(jp),
                _lr_sum(port.OCFG, 20), port.OCFG.weight_decay, "gcn")


# ------------------------------------------------------------ the driver
def _args(ck, *extra):
    return ["--arch", "qwen3-0.6b", "--steps", "60", "--batch", "2",
            "--seq", "32", "--ckpt-dir", str(ck), "--ckpt-every", "10",
            "--log-every", "100", "--device", "cpu", *extra]


def _arrays(ck, step: int) -> dict:
    with np.load(Path(ck) / f"step_{step:09d}" / "arrays.npz") as f:
        return {k: f[k] for k in f.files}


def test_train_driver_end_to_end(tmp_path, capsys):
    """Loss goes down, an injected failure + resume continues exactly:
    the resumed run's step-60 weights and moments equal an uninterrupted
    run's bit for bit."""
    ck = tmp_path / "run"
    with pytest.raises(RuntimeError, match="injected failure at step 30"):
        T_TRAIN.main(_args(ck, "--fail-at-step", "30"))
    assert checkpoint.latest_step(ck) == 30
    assert T_TRAIN.main(_args(ck)) == 0
    assert checkpoint.latest_step(ck) == 60
    out = capsys.readouterr().out
    assert "[resume] restored step 30" in out and "[done] loss" in out
    straight = tmp_path / "straight"
    assert T_TRAIN.main(_args(straight)) == 0
    assert "(improved)" in capsys.readouterr().out
    got, want = _arrays(ck, 60), _arrays(straight, 60)
    assert len(got) == len(want) > 40
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_either_package_resumes_the_other(tmp_path, capsys):
    """The reference's driver crashes at step 10; the port's resumes its
    checkpoint and crashes at 15; the reference's resumes the port's and
    ends at 20."""
    ck = str(tmp_path / "run")
    common = ["--arch", "qwen3-0.6b", "--steps", "20", "--batch", "2",
              "--seq", "16", "--ckpt-dir", ck, "--ckpt-every", "5",
              "--log-every", "100"]
    with pytest.raises(RuntimeError):
        J_TRAIN.main(common + ["--fail-at-step", "10"])
    with pytest.raises(RuntimeError):
        T_TRAIN.main(common + ["--fail-at-step", "15", "--device", "cpu"])
    assert checkpoint.latest_step(ck) == 15
    assert J_TRAIN.main(common) == 0
    assert checkpoint.latest_step(ck) == 20
    out = capsys.readouterr().out
    assert "[resume] restored step 10" in out
    assert "[resume] restored step 15" in out


def test_train_driver_runs_on_the_card_by_default(monkeypatch):
    """Without ``--device`` the driver asks for ``"cuda"``."""
    asked = []

    def refuse(device=None):
        asked.append(device)
        raise RuntimeError("no card here")
    monkeypatch.setattr(T_TRAIN, "resolve_device", refuse)
    with pytest.raises(RuntimeError, match="no card here"):
        T_TRAIN.main(["--steps", "1"])
    assert asked == ["cuda"]


def test_train_driver_refuses_a_non_lm_arch():
    with pytest.raises(ValueError, match="LM archs"):
        T_TRAIN.main(["--arch", "gcn-cora", "--device", "cpu"])
