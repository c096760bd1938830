"""All 20 LM step cells (5 archs x ``train_4k``, ``prefill_32k``,
``decode_32k``, ``long_500k``) of the port against the reference's, at
mesh (1, 1), on the CPU.

Each cell is built by both packages' ``launch.steps`` at its arch's
smoke config in float32, with the shape's dims cut small (named in each
case's id): ``train_4k`` to batch 2 x sequence 16, ``prefill_32k`` to
batch 2 x 16, ``decode_32k`` to batch 2 and a 16-position cache,
``long_500k`` to batch 1 and a 32-position cache. At (1, 1) every mesh
field is set (the reference's branches: the MoE's ``shard_map`` path,
MLA flash-decoding in the decode cells, the vocab-parallel lookup and
NLL where the sequence divides), and every collective is over one rank.
The port runs over a one-rank gloo group (a ``FileStore`` under the
test's temporary directory), its arguments ``DTensor``s placed by the
cell's specs; the reference's cell is jitted on a one-device mesh with
``Auto`` axes. The inputs are the port's ``example_args``; the
reference gets copies and finishes before the port's step runs (the
port updates its donated arguments in place, and JAX may alias a numpy
buffer and runs asynchronously). Every output lane (a train step's
parameters, moments, step and loss; the logits; a decode step's logits,
caches and length) within rtol 1e-4, atol 1e-5, integer lanes equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as JP

from repro.configs import registry as J_REG
from repro.configs.common import ShapeCell as JShapeCell
from repro.launch import steps as J_STEPS
from repro_torch.configs import registry as T_REG
from repro_torch.configs.common import ShapeCell
from repro_torch.launch import mesh as T_MESH
from repro_torch.launch import sharding as T_SH
from repro_torch.launch import steps as T_STEPS

SMALL = {"train_4k": dict(seq_len=16, global_batch=2),
         "prefill_32k": dict(seq_len=16, global_batch=2),
         "decode_32k": dict(kv_len=16, global_batch=2),
         "long_500k": dict(kv_len=32, global_batch=1)}
LM_ARCHS = [a for a, s in T_REG.ARCHS.items() if s.family == "lm"]
CELLS = [(a, s) for a in LM_ARCHS for s in SMALL]
IDS = [f"{a}-{s}-" + "x".join(f"{k}{v}" for k, v in SMALL[s].items())
       for a, s in CELLS]


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    store = tmp_path_factory.mktemp("lm_cells") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        yield (T_MESH.make_host_test_mesh(),
               jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2))
    finally:
        dist.destroy_process_group()


def _f32(spec, f32):
    return dataclasses.replace(spec, config=dataclasses.replace(
        spec.smoke_config, param_dtype=f32, compute_dtype=f32))


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def test_there_are_twenty_lm_cells():
    lm = [(a, s) for a, s in T_REG.all_cells()
          if T_REG.ARCHS[a].family == "lm"]
    assert sorted(lm) == sorted(CELLS) and len(CELLS) == 20


@pytest.mark.parametrize("arch,shape_name", CELLS, ids=IDS)
def test_lm_cell_equals_the_reference(meshes, arch, shape_name):
    t_mesh, j_mesh = meshes
    t_spec = _f32(T_REG.get_arch(arch), torch.float32)
    j_spec = _f32(J_REG.get_arch(arch), jnp.float32)
    kind = t_spec.shape(shape_name).kind
    shape = ShapeCell(shape_name, kind, SMALL[shape_name])
    t_cell = T_STEPS.build_cell_of(t_spec, shape, t_mesh)
    build = {"train": J_STEPS._lm_train_cell,
             "prefill": J_STEPS._lm_prefill_cell,
             "decode": J_STEPS._lm_decode_cell}[kind]
    j_cell = build(j_spec, JShapeCell(shape_name, kind, SMALL[shape_name]),
                   j_mesh)
    cfg = t_cell.static["cfg"]
    assert cfg.mesh is t_mesh and (cfg.moe is None or cfg.moe.mesh is t_mesh)
    if kind == "decode":
        assert t_cell.static["decode_flash"] == (cfg.mla is not None)

    args = T_STEPS.example_args(t_spec, shape, t_cell, seed=5, device="cpu")
    flat = {_key(p): t.numpy().copy()
            for p, t in T_SH.tree_leaves_with_path(args)}
    ref_args = jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(flat[_key(p)]), j_cell.args)
    named = lambda t: jax.tree.map(                      # noqa: E731
        lambda s: NamedSharding(j_mesh, s), t,
        is_leaf=lambda x: isinstance(x, JP))
    with j_mesh:
        want = jax.block_until_ready(jax.jit(
            j_cell.fn, in_shardings=tuple(named(s) for s in j_cell.in_specs),
            out_shardings=named(j_cell.out_specs))(*ref_args))
    got = T_SH.full(t_cell.fn(*T_SH.distribute(args, t_cell.in_specs,
                                              t_mesh)))
    g = {_key(p): t.detach().numpy()
         for p, t in T_SH.tree_leaves_with_path(got)}
    w = {_key(p): np.asarray(a)
         for p, a in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(g) == set(w)
    for k, wv in w.items():
        assert g[k].shape == wv.shape, k
        if np.issubdtype(wv.dtype, np.floating):
            assert np.isfinite(g[k]).all(), k
            np.testing.assert_allclose(g[k], wv, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g[k].astype(wv.dtype), wv,
                                          err_msg=k)

