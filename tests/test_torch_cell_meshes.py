"""The non-LM step cells on meshes (``repro_torch.launch.steps``: the
paper's matcher cells, the GNN, equivariant and DIN cells) against the
JAX package's, on four host ranks.

Two meshes: 2 x 2 ``("data", "model")`` and 2 x 1 x 2 ``("pod", "data",
"model")``, whose batch axis is the tuple ``("pod", "data")``. On each:

* the matcher's wave cell (``expand_wave_mq``) and stack cell
  (``run_device_megastep``), each on the dense adjacency and on the
  two-level (hier) layout, at ``tests/test_torch_launch.py``'s
  ``MATCHER_DIMS`` (256 vertices, wave 64, kpr 4, 4 slots; the stack
  cell 128 entries deep, megastep depth 6), on
  ``powerlaw_graph(256, 3, 6, seed=2)`` with three five-vertex queries:
  the adjacency (or the hier summary) split over ``model``, the lanes
  over the data axes, the banks replicated. Every output lane, the
  updated Δ store and stacks included, bit for bit;
* the GNN (full graph, sampled, molecules), equivariant (sampled,
  molecules) and DIN (train, serve, retrieval) cells at their smoke
  configs in float32: every output lane (updated weights and moments,
  loss, scores) within rtol 1e-4, atol 1e-5 (``tests/test_archs.py``'s
  rule).

The inputs are drawn once in this process (``matcher_args``;
``example_args``, seed 5). The reference runs every case in one
subprocess whose jax sees 4 host devices (meshes with ``Auto`` axes;
its CPU default kernel backend, ``jnp``), jitted with the cells' in and
out shardings; the port in four subprocesses, one gloo rank each over a
``FileStore``, the arguments ``DTensor``s placed by the cells' specs
(``sharding.distribute``), the results gathered whole
(``sharding.full``).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

from repro_torch.configs import registry as T_REG
from repro_torch.configs.common import ShapeCell
from repro_torch.data.graph_gen import powerlaw_graph, query_set
from repro_torch.launch import mesh as T_MESH
from repro_torch.launch import sharding as T_SH
from repro_torch.launch import steps as T_STEPS

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
MATCHER_DIMS = dict(n_vertices=256, wave_size=64, kpr=4, n_slots=4,
                    pattern_capacity=256)
STACKS = dict(stack_capacity=128, megastep_depth=6)
MATCHER = {"wave": {}, "wave_hier": {"hier_adjacency": True},
           "stacks": STACKS, "stacks_hier": dict(STACKS,
                                                 hier_adjacency=True)}
SMALL = {
    "full_graph": dict(n_nodes=40, n_edges=90, d_feat=24, n_classes=5),
    "sampled": dict(n_nodes=0, n_edges=0, batch_nodes=4, fanout0=3,
                    fanout1=2, d_feat=12, n_classes=5),
    "batched_graphs": dict(n_nodes=6, n_edges=7, batch=4, n_species=5),
    "recsys_train": dict(batch=16),
    "recsys_serve": dict(batch=16),
    "recsys_retrieval": dict(batch=1, n_candidates=48),
}
MODELS = [("gcn-cora", "full_graph"), ("gin-tu", "sampled"),
          ("gcn-cora", "batched_graphs"), ("nequip", "sampled"),
          ("mace", "batched_graphs"), ("din", "recsys_train"),
          ("din", "recsys_serve"), ("din", "recsys_retrieval")]
RTOL, ATOL = 1e-4, 1e-5
TIMEOUT_S = 600

_REFERENCE = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import registry as R
from repro.configs.common import ShapeCell
from repro.launch import steps as S


def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                  getattr(k, "name", k))))
                    for k in path)


cases = json.load(open(sys.argv[1]))
inp = np.load(sys.argv[2])
out = {}
build = {"full_graph": S._gnn_full_cell, "sampled": S._gnn_sampled_cell,
         "batched_graphs": S._gnn_mol_cell}
for c in cases:
    name = c["name"]
    mesh = jax.make_mesh(tuple(c["shape"]), tuple(c["axes"]),
                         axis_types=(jax.sharding.AxisType.Auto,)
                         * len(c["axes"]))
    spec = R.get_arch(c["arch"])
    shape = ShapeCell(c["kind"], c["kind"], c["dims"])
    if spec.family == "matcher":
        cell = (S._matcher_stack_cell if "stack_capacity" in c["dims"]
                else S._matcher_cell)(spec, shape, mesh)
    else:
        spec = dataclasses.replace(spec, config=spec.smoke_config)
        cell = {"gnn": build.get(c["kind"]), "equiv": S._equiv_cells,
                "recsys": S._din_cells}[spec.family](spec, shape, mesh)

    def arg(p, s):
        a = inp[f"{name}|{key(p)}"]
        return jnp.asarray(a.view(np.uint32) if s.dtype == jnp.uint32
                           else a.astype(s.dtype))
    args = jax.tree_util.tree_map_with_path(arg, cell.args)
    named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                   is_leaf=lambda x: isinstance(x, P))
    with mesh:
        res = jax.jit(cell.fn,
                      in_shardings=tuple(named(s) for s in cell.in_specs),
                      out_shardings=named(cell.out_specs))(*args)
    for p, a in jax.tree_util.tree_flatten_with_path(res)[0]:
        out[f"{name}|{key(p)}"] = np.asarray(a)
np.savez(sys.argv[3], **out)
'''

_PORT = r'''
import sys, json, dataclasses
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import registry as R
from repro_torch.configs.common import ShapeCell
from repro_torch.data.graph_gen import powerlaw_graph, query_set
from repro_torch.launch import steps as S, sharding as SH

rank, store, world = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
cases = json.load(open(sys.argv[4]))
inp = np.load(sys.argv[5])
out = {}
key = lambda path: "/".join(str(k) for k in path)
for c in cases:
    name = c["name"]
    mesh = init_device_mesh("cpu", tuple(c["shape"]),
                            mesh_dim_names=tuple(c["axes"]))
    spec = R.get_arch(c["arch"])
    shape = ShapeCell(c["kind"], c["kind"], c["dims"])
    if spec.family == "matcher":
        cell = S.build_cell_of(spec, shape, mesh)
        data = powerlaw_graph(c["dims"]["n_vertices"], 3, 6, seed=2)
        args = S.matcher_args(c["dims"], data,
                              query_set(data, 5, 3, seed=3), device="cpu")
    else:
        spec = dataclasses.replace(spec, config=spec.smoke_config)
        cell = S.build_cell_of(spec, shape, mesh)
        args = SH.tree_map_with_path(
            lambda p, t: torch.from_numpy(inp[f"{name}|{key(p)}"].copy()),
            cell.args)
    res = SH.full(cell.fn(*SH.distribute(args, cell.in_specs, mesh)))
    for p, a in SH.tree_leaves_with_path(res):
        out[f"{name}|{key(p)}"] = a.detach().numpy()
if rank == 0:
    np.savez(sys.argv[6], **out)
dist.destroy_process_group()
'''


def _key(path) -> str:
    return "/".join(str(k) for k in path)


CASES = ([dict(name=f"{m}-matcher-{label}", shape=MESHES[m][0],
               axes=MESHES[m][1], arch="paper-matcher", kind="matcher",
               dims=dict(MATCHER_DIMS, **extra))
          for m in MESHES for label, extra in MATCHER.items()]
         + [dict(name=f"{m}-{arch}-{kind}", shape=MESHES[m][0],
                 axes=MESHES[m][1], arch=arch, kind=kind, dims=SMALL[kind])
            for m in MESHES for arch, kind in MODELS])


def _matcher_inputs(c: dict) -> dict:
    """The matcher case's arguments keyed as the reference's tree has
    them: the hier layout's shape-only ``chunk_pad`` lane (the port's
    static ``kmax``) is zeros of that length."""
    data = powerlaw_graph(c["dims"]["n_vertices"], 3, 6, seed=2)
    args = T_STEPS.matcher_args(c["dims"], data,
                                query_set(data, 5, 3, seed=3), device="cpu")
    out = {f"{c['name']}|{_key(p)}": t.numpy()
           for p, t in T_SH.tree_leaves_with_path(args)}
    if c["dims"].get("hier_adjacency"):
        out[f"{c['name']}|0/chunk_pad"] = np.zeros(args[0].kmax, np.int32)
    return out


def _inputs() -> dict:
    """Every case's arguments keyed ``case|path``; the model cells' drawn
    by ``example_args`` (seed 5) over a fake 4-rank group."""
    inp = {}
    T_MESH.init_fake_group(4)
    try:
        for c in CASES:
            if c["arch"] == "paper-matcher":
                inp.update(_matcher_inputs(c))
                continue
            mesh = T_MESH.make_host_test_mesh(c["shape"], c["axes"])
            spec = T_REG.get_arch(c["arch"])
            spec = dataclasses.replace(spec, config=spec.smoke_config)
            shape = ShapeCell(c["kind"], c["kind"], c["dims"])
            cell = T_STEPS.build_cell_of(spec, shape, mesh)
            for p, t in T_SH.tree_leaves_with_path(T_STEPS.example_args(
                    spec, shape, cell, seed=5, device="cpu")):
                inp[f"{c['name']}|{_key(p)}"] = t.numpy()
    finally:
        dist.destroy_process_group()
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cell_meshes")
    (d / "cases.json").write_text(json.dumps(CASES))
    np.savez(d / "inp.npz", **_inputs())
    (d / "ref.py").write_text(_REFERENCE)
    (d / "port.py").write_text(_PORT)
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               REPRO_TUNING_DISABLE="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmds = [[sys.executable, str(d / "ref.py"), str(d / "cases.json"),
             str(d / "inp.npz"), str(d / "ref.npz")]]
    cmds += [[sys.executable, str(d / "port.py"), str(r), str(d / "store"),
              "4", str(d / "cases.json"), str(d / "inp.npz"),
              str(d / "port.npz")] for r in range(4)]
    logs = [open(d / f"log{i}.txt", "w") for i in range(len(cmds))]
    procs = [subprocess.Popen(c, env=env, stdout=log, stderr=log)
             for c, log in zip(cmds, logs)]
    try:
        rcs = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for i, rc in enumerate(rcs):
        assert rc == 0, (f"{'reference' if i == 0 else f'rank {i - 1}'} "
                         f"exited {rc}:\n"
                         + (d / f"log{i}.txt").read_text()[-3000:])
    return {"ref": dict(np.load(d / "ref.npz")),
            "port": dict(np.load(d / "port.npz"))}


def _compare(runs, name: str) -> int:
    """Every lane of the reference's output of case ``name`` against the
    port's: floats by the rule, the rest bit for bit (uint32 words as
    the port's int32)."""
    ref, port = runs["ref"], runs["port"]
    keys = sorted(k for k in ref if k.startswith(f"{name}|"))
    assert keys
    for k in keys:
        w, g = ref[k], port[k]
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        else:
            w = w.view(np.int32) if w.dtype == np.uint32 else w
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=k)
    return len(keys)


MATCHER_IDS = [(m, label) for m in MESHES for label in MATCHER]


@pytest.mark.parametrize("mesh,label", MATCHER_IDS,
                         ids=[f"{m}-{lb}" for m, lb in MATCHER_IDS])
def test_matcher_cell_bit_for_bit(runs, mesh, label):
    name = f"{mesh}-matcher-{label}"
    port = runs["port"]
    if label.startswith("stacks"):
        assert _compare(runs, name) >= 30
        assert port[f"{name}|d_expanded"].sum() > 0
        assert port[f"{name}|d_rows"].sum() > 0
        assert port[f"{name}|n_emb"] > 0 or port[f"{name}|d_prunes"].sum() \
            + port[f"{name}|d_stored"].sum() > 0
    else:
        assert _compare(runs, name) >= 15
        assert port[f"{name}|0/n_children"].sum() > 0


MODEL_IDS = [(m, a, k) for m in MESHES for a, k in MODELS]


@pytest.mark.parametrize("mesh,arch,kind", MODEL_IDS,
                         ids=[f"{m}-{a}-{k}" for m, a, k in MODEL_IDS])
def test_model_cell_within_the_rule(runs, mesh, arch, kind):
    name = f"{mesh}-{arch}-{kind}"
    n = _compare(runs, name)
    if kind.startswith("recsys_") and kind != "recsys_train":
        assert n == 1
        return
    assert n >= 5                       # weights, moments, step, loss
    loss = runs["port"][f"{name}|2"]
    assert loss.shape == () and np.isfinite(loss)
    assert int(runs["port"][f"{name}|1/step"]) == 6
