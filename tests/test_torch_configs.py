"""The port's architecture registry and configs (``repro_torch.configs``)
against the JAX package's, and the port's own initialisation of every
family against the reference's ``*_init``, on the CPU.

Configs compare field by field (nested configs recursively, dtypes by
name). The port's init must give, after ``convert``'s naming, the
reference's parameter names, shapes and dtypes, and each leaf of at
least 1024 elements a standard deviation within 10 % of the reference
leaf's (the sampling spread of a 1024-element std is about 2 %). Every
``FULL`` config is built on ``"meta"`` (no memory, no draws): its
parameter count must equal the reference init's, from
``jax.eval_shape``, and for the LMs its matrices must count to
``n_params()``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as J_REG
from repro.models import equivariant as JE
from repro.models import gnn as JG
from repro.models import recsys as JR
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import registry as T_REG
from repro_torch.models import equivariant as TE
from repro_torch.models import gnn as TG
from repro_torch.models import recsys as TR
from repro_torch.models import transformer as TT

MODEL_ARCHS = [a for a in T_REG.ARCHS if a != "paper-matcher"]
LM_ARCHS = [a for a in MODEL_ARCHS if T_REG.ARCHS[a].family == "lm"]
J_INIT = {"lm": JT.lm_init, "gnn": JG.gnn_init, "equiv": JE.equiv_init,
          "recsys": JR.din_init}
T_INIT = {"lm": TT.lm_init, "gnn": TG.gnn_init, "equiv": TE.equiv_init,
          "recsys": TR.din_init}


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _same(port, ref, where: str) -> None:
    if dataclasses.is_dataclass(ref):
        assert type(port).__name__ == type(ref).__name__, where
        names = [f.name for f in dataclasses.fields(ref)]
        assert [f.name for f in dataclasses.fields(port)] == names, where
        for n in names:
            _same(getattr(port, n), getattr(ref, n), f"{where}.{n}")
    elif isinstance(port, torch.dtype):
        assert _dtype_name(port) == _dtype_name(ref), where
    else:
        assert port == ref, where


@pytest.mark.parametrize("arch", list(J_REG.ARCHS))
def test_arch_spec_equals_the_reference_field_by_field(arch):
    port, ref = T_REG.get_arch(arch), J_REG.get_arch(arch)
    for field in ("arch_id", "family", "notes"):
        assert getattr(port, field) == getattr(ref, field), field
    assert len(port.shapes) == len(ref.shapes)
    for p_cell, r_cell in zip(port.shapes, ref.shapes):
        _same(p_cell, r_cell, f"{arch}.{r_cell.name}")
    _same(port.config, ref.config, f"{arch}.FULL")
    _same(port.smoke_config, ref.smoke_config, f"{arch}.SMOKE")


def test_registry_lists_and_cells():
    assert list(T_REG.ARCHS) == list(J_REG.ARCHS)
    assert T_REG.ASSIGNED == J_REG.ASSIGNED
    for matcher in (False, True):
        assert T_REG.all_cells(matcher) == J_REG.all_cells(matcher)
    with pytest.raises(KeyError):
        T_REG.get_arch("no-such-arch")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_counts_equal(arch):
    for which in ("config", "smoke_config"):
        port = getattr(T_REG.ARCHS[arch], which)
        ref = getattr(J_REG.ARCHS[arch], which)
        assert port.n_params() == ref.n_params()
        assert port.n_active_params() == ref.n_active_params()


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_port_init_matches_the_reference_init(arch):
    spec = T_REG.ARCHS[arch]
    gen = torch.Generator().manual_seed(0)
    port = T_INIT[spec.family](gen, spec.smoke_config, device="cpu")
    ref = J_INIT[spec.family](jax.random.key(0),
                              J_REG.ARCHS[arch].smoke_config)
    want = convert.flatten_params(jax.tree_util.tree_map(np.asarray, ref),
                                  stacked=("layers",) if spec.family == "lm"
                                  else ())
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        w = want[name]
        assert tuple(p.shape) == w.shape, name
        assert _dtype_name(p.dtype) == w.dtype.name, name
        if w.size >= 1024:
            sd, want_sd = p.float().std().item(), w.astype(np.float32).std()
            assert abs(sd - want_sd) <= 0.1 * want_sd, (name, sd, want_sd)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_full_config_on_meta_counts_the_reference_parameters(arch):
    spec = T_REG.ARCHS[arch]
    port = T_INIT[spec.family](None, spec.config, device="meta")
    assert all(p.is_meta for p in port.parameters())
    shapes = jax.eval_shape(lambda k: J_INIT[spec.family](
        k, J_REG.ARCHS[arch].config), jax.random.key(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        shapes))
    assert sum(p.numel() for p in port.parameters()) == want
    if spec.family == "lm":
        matrices = sum(p.numel() for n, p in port.named_parameters()
                       if p.dim() >= 2 and not n.startswith("mtp."))
        assert matrices == spec.config.n_params()


def test_the_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = T_REG.ARCHS["qwen3-0.6b"].smoke_config
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.lm_init(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_decode_state(cfg, 1, 4)
