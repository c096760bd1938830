"""The port's mesh, sharding rules and step cells
(``repro_torch.launch.mesh`` / ``sharding`` / ``steps``) against the JAX
package's ``repro.launch``, on the CPU.

Placements: every cell of ``all_cells(include_matcher=True)`` is built
by both packages on the 16 x 16 and the 2 x 16 x 16 production meshes.
The reference's side runs in a subprocess whose jax sees 512 host
devices (``--xla_force_host_platform_device_count`` must be set before
jax is first imported); the port's builds the same meshes in this
process over a fake process group. Each argument leaf (by its path in
the argument tree) must have the reference's global shape and dtype
(the reference's uint32 bitmap words are the port's int32), the
reference's partition spec entry by entry, and the reference's local
shard shape (the port's: ``distribute_tensor`` of a ``meta`` tensor, to
``to_local()``; the reference's: ``NamedSharding(...).shard_shape``);
each output spec leaf must equal the reference's.

Values: the matcher, GNN, equivariant and DIN builders at small shape
cells (the published configs; DIN at its smoke config), the same
numpy-drawn inputs through the reference's jitted ``fn`` and the port's.
Integer, boolean and bitmap lanes must be equal bit for bit; float
lanes within rtol 1e-4, atol 1e-5 (the reference's own model tests'
rule, ``tests/test_archs.py``), forces-free losses included.

The LM cells' values are held in ``tests/test_torch_lm_cells.py`` (mesh
(1, 1)) and ``tests/test_torch_mesh_paths.py`` (four ranks).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as J_REG
from repro.configs.common import ShapeCell as JShapeCell
from repro.launch import mesh as J_MESH
from repro.launch import steps as J_STEPS
from repro_torch.configs import registry as T_REG
from repro_torch.configs.common import ShapeCell
from repro_torch.data.graph_gen import powerlaw_graph, query_set
from repro_torch.launch import mesh as T_MESH
from repro_torch.launch import sharding as T_SH
from repro_torch.launch import steps as T_STEPS

ROOT = Path(__file__).resolve().parents[1]
CELLS = T_REG.all_cells(include_matcher=True)

_REFERENCE_CELLS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import all_cells
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build_cell


def key(k):
    for a in ("key", "idx", "name"):
        if hasattr(k, a):
            return getattr(k, a)
    raise TypeError(k)


def entry(e):
    return list(e) if isinstance(e, tuple) else e


def leaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [([key(k) for k in path], leaf) for path, leaf in flat]


out = {}
for multi_pod in (False, True):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for arch, shape in all_cells(include_matcher=True):
        cell = build_cell(arch, shape, mesh)
        specs = {json.dumps(p): s for p, s in
                 leaves(cell.in_specs, lambda x: isinstance(x, P))}
        args = []
        for path, sds in leaves(cell.args):
            spec = specs[json.dumps(path)]
            args.append([path, list(sds.shape), sds.dtype.name,
                         [entry(e) for e in spec],
                         list(NamedSharding(mesh, spec)
                              .shard_shape(sds.shape))])
        outs = [[path, [entry(e) for e in s]] for path, s in
                leaves(cell.out_specs, lambda x: isinstance(x, P))]
        out[f"{int(multi_pod)}/{arch}/{shape}"] = {"args": args,
                                                   "out": outs}
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference_cells() -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE_CELLS],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout)


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _port_cells(multi_pod: bool) -> dict:
    """Every cell built by the port on a production mesh over a fake
    process group, as the reference's JSON has them."""
    T_MESH.init_fake_group(512 if multi_pod else 256)
    try:
        mesh = T_MESH.make_production_mesh(multi_pod=multi_pod)
        out = {}
        for arch, shape in CELLS:
            cell = T_STEPS.build_cell(arch, shape, mesh)
            specs = {json.dumps(list(p)): s for p, s in
                     T_SH.tree_leaves_with_path(cell.in_specs)}
            args = []
            for path, t in T_SH.tree_leaves_with_path(cell.args):
                spec = specs[json.dumps(list(path))]
                local = T_SH.shard(t, spec, mesh).to_local()
                args.append([list(path), list(t.shape),
                             str(t.dtype).removeprefix("torch."),
                             [_entry(e) for e in spec], list(local.shape)])
            outs = [[list(p), [_entry(e) for e in s]] for p, s in
                    T_SH.tree_leaves_with_path(cell.out_specs)]
            out[f"{int(multi_pod)}/{arch}/{shape}"] = {"args": args,
                                                       "out": outs}
        return out
    finally:
        dist.destroy_process_group()


def _by_path(rows) -> dict:
    return {json.dumps(r[0]): r[1:] for r in rows}


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_every_cell_places_its_arguments_as_the_reference(reference_cells,
                                                          multi_pod):
    port = _port_cells(multi_pod)
    assert len(port) == len(CELLS) == 43
    n_leaves = 0
    for name, got in port.items():
        want = reference_cells[name]
        g_args, w_args = _by_path(got["args"]), _by_path(want["args"])
        assert set(g_args) == set(w_args), name
        for path, (shape, dtype, spec, local) in g_args.items():
            w_shape, w_dtype, w_spec, w_local = w_args[path]
            where = f"{name} {path}"
            assert shape == w_shape, where
            assert dtype == ("int32" if w_dtype == "uint32" else w_dtype), \
                where
            assert spec == w_spec, where
            assert local == w_local, where
            n_leaves += 1
        assert _by_path(got["out"]) == _by_path(want["out"]), name
    assert n_leaves > 2000


def test_the_production_meshes():
    for multi_pod, shape, axes in ((False, (16, 16), ("data", "model")),
                                   (True, (2, 16, 16),
                                    ("pod", "data", "model"))):
        T_MESH.init_fake_group(512 if multi_pod else 256)
        try:
            mesh = T_MESH.make_production_mesh(multi_pod=multi_pod)
            assert tuple(mesh.shape) == shape
            assert mesh.mesh_dim_names == axes
            assert T_MESH.dp_axes(mesh) == axes[:-1]
            assert T_SH.dp(mesh) == (("pod", "data") if multi_pod
                                     else "data")
        finally:
            dist.destroy_process_group()


def test_placements_split_major_to_minor_and_refuse_other_orders():
    T_MESH.init_fake_group(512)
    try:
        mesh = T_MESH.make_production_mesh(multi_pod=True)
        got = T_SH.placements(T_SH.P(("pod", "data"), None, "model"), mesh)
        assert [str(p) for p in got] == ["S(0)", "S(0)", "S(2)"]
        t = torch.empty((64, 3, 32), device="meta")
        assert T_SH.shard(t, T_SH.P(("pod", "data", "model"), None, None),
                          mesh).to_local().shape == (1, 3, 32)
        with pytest.raises(ValueError, match="order"):
            T_SH.placements(T_SH.P(("data", "pod")), mesh)
        assert T_SH._sanitize(T_SH.P("model", ("pod", "data")), (40, 64),
                              mesh) == T_SH.P(None, ("pod", "data"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- values
@pytest.fixture
def one_device_meshes():
    """A (1, 1) mesh in each package (the port's over a 1-rank fake
    group); the cells' values do not depend on the mesh."""
    T_MESH.init_fake_group(1)
    try:
        yield T_MESH.make_host_test_mesh(), J_MESH.make_host_test_mesh()
    finally:
        dist.destroy_process_group()


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _to_ref(port, ref):
    """The port's arguments as the reference's (``ref`` is its
    ShapeDtypeStruct tree): same values, uint32 where the reference
    has it."""
    if ref is None:
        return None
    if isinstance(ref, tuple) and hasattr(ref, "_fields"):
        return type(ref)(*(_to_ref(getattr(port, f, None), r)
                           for f, r in zip(ref._fields, ref)))
    if isinstance(ref, dict):
        return {k: _to_ref(port[k], r) for k, r in ref.items()}
    if isinstance(ref, (list, tuple)):
        return type(ref)(_to_ref(p, r) for p, r in zip(port, ref))
    a = _np(port)
    if a.dtype.name == "bfloat16":
        raise TypeError("bf16 argument")
    return jnp.asarray(a.view(np.uint32) if ref.dtype == jnp.uint32
                       else a.astype(ref.dtype))


def _clone(tree):
    return T_SH.tree_map(lambda t: t.clone(), tree)


def _compare(got, want, where: str) -> int:
    """Every lane of the port's output ``got`` against the reference's
    ``want``; returns the number of lanes compared."""
    if want is None:
        return 0
    if isinstance(want, tuple) and hasattr(want, "_fields"):
        return sum(_compare(getattr(got, f), w, f"{where}.{f}")
                   for f, w in zip(want._fields, want))
    if isinstance(want, dict):
        assert set(got) == set(want), where
        return sum(_compare(got[k], w, f"{where}/{k}")
                   for k, w in want.items())
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        return sum(_compare(g, w, f"{where}/{i}")
                   for i, (g, w) in enumerate(zip(got, want)))
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape, where
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                   err_msg=where)
    else:
        w = w.view(np.int32) if w.dtype == np.uint32 else w
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=where)
    return 1


def _matcher_pair(dims: dict, meshes):
    t_mesh, j_mesh = meshes
    cell = ShapeCell("small", "matcher", dims)
    t_spec = T_REG.get_arch("paper-matcher")
    j_spec = J_REG.get_arch("paper-matcher")
    t_cell = T_STEPS.build_cell_of(t_spec, cell, t_mesh)
    build = (J_STEPS._matcher_stack_cell if "stack_capacity" in dims
             else J_STEPS._matcher_cell)
    j_cell = build(j_spec, JShapeCell("small", "matcher", dims), j_mesh)
    data = powerlaw_graph(dims["n_vertices"], 3, 6, seed=2)
    queries = query_set(data, 5, dims["n_slots"] - 1, seed=3)
    args = T_STEPS.matcher_args(dims, data, queries, device="cpu")
    return t_cell, j_cell, args


MATCHER_DIMS = dict(n_vertices=256, wave_size=64, kpr=4, n_slots=4,
                    pattern_capacity=256)


@pytest.mark.parametrize("stacks,on_dtensors", [
    (False, False), (True, False), (False, True), (True, True)],
    ids=["wave", "stacks", "wave-dtensors", "stacks-dtensors"])
def test_matcher_cells_equal_the_reference(one_device_meshes, stacks,
                                           on_dtensors):
    """On plain tensors, and on ``DTensor``s placed by the cell's specs
    over the one-rank group (the mesh step: local tensors, the split
    refine), read back whole."""
    dims = dict(MATCHER_DIMS, **({"stack_capacity": 128,
                                  "megastep_depth": 6} if stacks else {}))
    t_cell, j_cell, args = _matcher_pair(dims, one_device_meshes)
    ref_args = _to_ref(args, j_cell.args)
    want = jax.jit(j_cell.fn)(*ref_args)
    if on_dtensors:
        got = T_SH.full(t_cell.fn(*T_SH.distribute(
            _clone(args), t_cell.in_specs, one_device_meshes[0])))
    else:
        got = t_cell.fn(*_clone(args))
    assert _compare(got, want, "out") >= 10
    if stacks:
        assert int(got.d_expanded.sum()) > 0 and int(got.d_rows.sum()) > 0
    else:
        assert int(got[0].n_children.sum()) > 0


def test_matcher_args_fill_the_wave_round_robin(one_device_meshes):
    dims = dict(MATCHER_DIMS, stack_capacity=128, megastep_depth=6)
    _, _, args = _matcher_pair(dims, one_device_meshes)
    g, qb, tb, sb, in_root, in_rid, in_slot, in_valid, active = args
    n = int(in_valid.sum())
    assert 0 < n <= 64 and active.tolist() == [True, True, True, False]
    assert not in_valid[n:].any()
    per_slot = [int((in_slot[:n] == s).sum()) for s in range(3)]
    assert in_slot[:n].tolist() == [s for j in range(max(per_slot))
                                    for s in range(3) if j < per_slot[s]]
    assert int(qb.n_query[:3].min()) == 5 and int(qb.n_query[3]) == 0
    for r, s in zip(in_root[:n].tolist(), in_slot[:n].tolist()):
        word = int(qb.cand_bitmap[s, 0, r // 32]) & 0xFFFFFFFF
        assert word >> (r % 32) & 1


SMALL = {
    "full_graph": dict(n_nodes=40, n_edges=90, d_feat=24, n_classes=5),
    "sampled": dict(n_nodes=0, n_edges=0, batch_nodes=4, fanout0=3,
                    fanout1=2, d_feat=12, n_classes=5),
    "batched_graphs": dict(n_nodes=6, n_edges=7, batch=3, n_species=5),
    "recsys_train": dict(batch=16),
    "recsys_serve": dict(batch=16),
    "recsys_retrieval": dict(batch=1, n_candidates=50),
}
MODEL_CASES = [("gcn-cora", "full_graph"), ("gin-tu", "full_graph"),
               ("gin-tu", "sampled"), ("gcn-cora", "batched_graphs"),
               ("nequip", "sampled"), ("mace", "batched_graphs"),
               ("din", "recsys_train"), ("din", "recsys_serve"),
               ("din", "recsys_retrieval")]


@pytest.mark.parametrize("arch,kind", MODEL_CASES,
                         ids=[f"{a}-{k}" for a, k in MODEL_CASES])
def test_model_cells_equal_the_reference(one_device_meshes, arch, kind):
    t_mesh, j_mesh = one_device_meshes
    t_spec, j_spec = T_REG.get_arch(arch), J_REG.get_arch(arch)
    if arch == "din":       # the published tables are 7.2 GB
        t_spec = dataclasses.replace(t_spec, config=t_spec.smoke_config)
        j_spec = dataclasses.replace(j_spec, config=j_spec.smoke_config)
    shape = ShapeCell(kind, kind, SMALL[kind])
    t_cell = T_STEPS.build_cell_of(t_spec, shape, t_mesh)
    builder = {"gnn": {"full_graph": J_STEPS._gnn_full_cell,
                       "sampled": J_STEPS._gnn_sampled_cell,
                       "batched_graphs": J_STEPS._gnn_mol_cell},
               "equiv": dict.fromkeys(SMALL, J_STEPS._equiv_cells),
               "recsys": dict.fromkeys(SMALL, J_STEPS._din_cells)}
    j_cell = builder[j_spec.family][kind](
        j_spec, JShapeCell(kind, kind, SMALL[kind]), j_mesh)
    args = T_STEPS.example_args(t_spec, shape, t_cell, seed=4,
                                device="cpu")
    ref_args = _to_ref(args, j_cell.args)
    want = jax.jit(j_cell.fn)(*ref_args)
    got = t_cell.fn(*_clone(args))
    n = _compare(got, want, f"{arch}/{kind}")
    assert n >= (3 if t_cell.donate else 1)
    if t_cell.donate:       # a train step: the step and the weights moved
        assert int(got[1]["step"]) == 6
        moved = [not torch.equal(a, b) for (_, a), (_, b) in zip(
            T_SH.tree_leaves_with_path(got[0]),
            T_SH.tree_leaves_with_path(args[0]))]
        assert all(moved)


def test_a_train_step_updates_its_donated_trees_in_place(
        one_device_meshes):
    t_mesh, _ = one_device_meshes
    spec = T_REG.get_arch("gcn-cora")
    shape = ShapeCell("full_graph", "full_graph", SMALL["full_graph"])
    cell = T_STEPS.build_cell_of(spec, shape, t_mesh)
    args = T_STEPS.example_args(spec, shape, cell, seed=1, device="cpu")
    before = _clone(args[0])
    params, opt, loss = cell.fn(*args)
    assert params is args[0] and opt["m"] is args[1]["m"]
    assert loss.dim() == 0 and torch.isfinite(loss)
    w = params["layers"][0]["lin"]["w"]
    assert not torch.equal(w, before["layers"][0]["lin"]["w"])


# ---------------------------------------------------------------- LM
LM_CELLS = [(a, s) for a, s in CELLS if T_REG.ARCHS[a].family == "lm"]


def test_lm_mesh_fields_follow_the_reference(one_device_meshes):
    """The fields the reference sets on the config, kept on the cell:
    MoE archs carry the expert axis, MLA archs their axes and, in the
    decode cells, flash-decoding."""
    t_mesh, _ = one_device_meshes
    ds = T_STEPS.build_cell("deepseek-v3-671b", "train_4k", t_mesh)
    f = ds.static["mesh_fields"]
    assert f["tp_axis"] == "model" and f["moe"]["ep_axis"] == "model"
    assert f["mla"] == {"dp_axis": "data", "tp_axis": "model"}
    dec = T_STEPS.build_cell("deepseek-v3-671b", "decode_32k", t_mesh)
    assert dec.static["decode_flash"] is True
    assert dec.static["mesh_fields"]["mla"]["decode_flash"] is True
    q = T_STEPS.build_cell("qwen3-0.6b", "decode_32k", t_mesh)
    assert q.static["decode_flash"] is False
    assert q.static["mesh_fields"]["tp_axis"] is None
