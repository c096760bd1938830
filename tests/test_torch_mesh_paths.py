"""The models' mesh paths (``repro_torch.models``: the vocab-parallel
embedding lookup and NLL, the expert-parallel ``_moe_shard_map``, MLA
flash-decoding and the sharding constraints) against the JAX package's,
on four host ranks.

Two meshes: 2 x 2 ``("data", "model")`` and 2 x 1 x 2 ``("pod", "data",
"model")``, whose batch axis is the tuple ``("pod", "data")``. On each,
the qwen3-0.6b (dense, GQA) and deepseek-v3-671b (MLA, MoE, MTP) smoke
configs in float32 go through the LM step cells (``launch.steps``) at
batch 4: a train step (sequence 16, so the NLL takes the vocab-parallel
branch: 16 % 2**2 == 0), a prefill (sequence 16) and a decode step
(cache 16, length 9; deepseek takes flash-decoding); and a decode step
at batch 1 (cache 32, length 17), which the data axes do not divide:
the branch with no mesh fields, whose caches shard the sequence over
(dp, model) and whose MoE runs with its experts whole on every rank
(``moe._moe_replicated``), the branch ``long_500k`` takes on the
production meshes. The inputs are the
port's ``example_args``, drawn once in this process. The reference runs
them in one subprocess whose jax sees 4 host devices (meshes with
``Auto`` axes: under jax 0.9 ``jax.make_mesh`` defaults to ``Explicit``
axes, where the reference's ``with_sharding_constraint`` refuses); the
port in four subprocesses, one gloo rank each over a ``FileStore``, the
arguments ``DTensor``s placed by the cells' specs, the results gathered
whole. Compared: the loss, every gradient leaf (``jax.grad`` of
``lm_loss`` against the port's backward), every updated parameter and
AdamW moment, the prefill logits, the decode logits and caches. Float
lanes within rtol 1e-4, atol 1e-5 (``tests/test_archs.py``'s rule);
integer lanes equal. A wrong transpose of a collective would show in the
gradients as a factor of the axis size, which these meshes of axis size
2 expose.

``_local_sort_dispatch`` (the MoE's sort-based bucketing) is held bit
for bit against the reference's on its own.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models import moe as J_MOE
from repro_torch.configs import registry as T_REG
from repro_torch.configs.common import ShapeCell
from repro_torch.launch import mesh as T_MESH
from repro_torch.launch import sharding as T_SH
from repro_torch.launch import steps as T_STEPS
from repro_torch.models import moe as T_MOE

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
ARCHS = ("qwen3-0.6b", "deepseek-v3-671b")
DIMS = {"train": ("train", dict(seq_len=16, global_batch=4)),
        "prefill": ("prefill", dict(seq_len=16, global_batch=4)),
        "decode": ("decode", dict(kv_len=16, global_batch=4)),
        "decode_b1": ("decode", dict(kv_len=32, global_batch=1))}
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
from repro.models.transformer import lm_loss


def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


cases = json.load(open(sys.argv[1]))
inp = np.load(sys.argv[2])
out = {}
for c in cases:
    name = c["name"]
    mesh = jax.make_mesh(tuple(c["shape"]), tuple(c["axes"]),
                         axis_types=(jax.sharding.AxisType.Auto,)
                         * len(c["axes"]))
    spec = R.get_arch(c["arch"])
    spec = dataclasses.replace(spec, config=dataclasses.replace(
        spec.smoke_config, param_dtype=jnp.float32,
        compute_dtype=jnp.float32))
    build = {"train": S._lm_train_cell, "prefill": S._lm_prefill_cell,
             "decode": S._lm_decode_cell}[c["kind"]]
    cell = build(spec, ShapeCell(c["kind"], c["kind"], c["dims"]), mesh)
    args = jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(inp[f"{name}|{key(p)}"]), cell.args)
    named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                   is_leaf=lambda x: isinstance(x, P))
    with mesh:
        res = jax.jit(cell.fn,
                      in_shardings=tuple(named(s) for s in cell.in_specs),
                      out_shardings=named(cell.out_specs))(*args)
        for p, a in jax.tree_util.tree_flatten_with_path(res)[0]:
            out[f"{name}|out|{key(p)}"] = np.asarray(a)
        if c["kind"] == "train":
            cfg = S._lm_param_trees(spec, mesh)[0]
            grads = jax.jit(
                jax.grad(lambda p, b: lm_loss(p, cfg, b)),
                in_shardings=(named(cell.in_specs[0]),
                              named(cell.in_specs[2])))(args[0], args[2])
            for p, a in jax.tree_util.tree_flatten_with_path(grads)[0]:
                out[f"{name}|grad|{key(p)}"] = np.asarray(a)
np.savez(sys.argv[3], **out)
'''

_PORT = r'''
import sys, json, dataclasses
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.configs.common import ShapeCell
from repro_torch.launch import steps as S, sharding as SH
from repro_torch.models.transformer import lm_loss

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
    spec = dataclasses.replace(spec, config=dataclasses.replace(
        spec.smoke_config, param_dtype=torch.float32,
        compute_dtype=torch.float32))
    cell = S.build_cell_of(spec, ShapeCell(c["kind"], c["kind"], c["dims"]),
                           mesh)

    def args():
        return SH.distribute(SH.tree_map_with_path(
            lambda p, t: torch.from_numpy(inp[f"{name}|{key(p)}"].copy()),
            cell.args), cell.in_specs, mesh)

    for p, a in SH.tree_leaves_with_path(SH.full(cell.fn(*args()))):
        out[f"{name}|out|{key(p)}"] = a.numpy()
    if c["kind"] == "train":
        cfg = cell.static["cfg"]
        params, _, batch = args()
        with S._spmd():
            model = S.bind_lm(cfg, params)
            lm_loss(model, cfg, batch).backward()
        grads = {n: p.grad.full_tensor() if p.grad is not None
                 else torch.zeros(p.shape)
                 for n, p in model.named_parameters()}
        for p, a in SH.tree_leaves_with_path(convert._nest(grads,
                                                           ("layers",))):
            out[f"{name}|grad|{key(p)}"] = a.numpy()
if rank == 0:
    np.savez(sys.argv[6], **out)
dist.destroy_process_group()
'''


def _f32(spec):
    return dataclasses.replace(spec, config=dataclasses.replace(
        spec.smoke_config, param_dtype=torch.float32,
        compute_dtype=torch.float32))


def _key(path) -> str:
    return "/".join(str(k) for k in path)


CASES = [dict(name=f"{m}-{a}-{label}", shape=MESHES[m][0],
              axes=MESHES[m][1], arch=a, kind=kind, dims=dims)
         for m in MESHES for a in ARCHS
         for label, (kind, dims) in DIMS.items()]


def _inputs() -> tuple[dict, dict]:
    """Every case's arguments (``example_args``, seed 3) keyed
    ``case|path``, and the config each cell built, over a fake 4-rank
    group."""
    T_MESH.init_fake_group(4)
    inp, cfgs = {}, {}
    try:
        for c in CASES:
            mesh = T_MESH.make_host_test_mesh(c["shape"], c["axes"])
            spec = _f32(T_REG.get_arch(c["arch"]))
            shape = ShapeCell(c["kind"], c["kind"], c["dims"])
            cell = T_STEPS.build_cell_of(spec, shape, mesh)
            cfgs[c["name"]] = cell.static["cfg"]
            for p, t in T_SH.tree_leaves_with_path(T_STEPS.example_args(
                    spec, shape, cell, seed=3, device="cpu")):
                inp[f"{c['name']}|{_key(p)}"] = t.numpy()
    finally:
        dist.destroy_process_group()
    return inp, cfgs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_paths")
    inp, cfgs = _inputs()
    (d / "cases.json").write_text(json.dumps(CASES))
    np.savez(d / "inp.npz", **inp)
    (d / "ref.py").write_text(_REFERENCE)
    (d / "port.py").write_text(_PORT)
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
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
            "port": dict(np.load(d / "port.npz")), "cfgs": cfgs, "inp": inp}


def _written_positions(runs, name: str, leaf: str) -> list:
    """Sequence positions where the decode step changed the cache leaf."""
    new = runs["port"][f"{name}|out|1/cache/{leaf}"]
    old = runs["inp"][f"{name}|1/cache/{leaf}"]
    changed = (new != old).reshape(new.shape[0], new.shape[1],
                                   new.shape[2], -1).any(axis=(0, 1, 3))
    return np.flatnonzero(changed).tolist()


def _compare(runs, prefix: str) -> int:
    ref, port = runs["ref"], runs["port"]
    keys = sorted(k for k in ref if k.startswith(prefix))
    assert keys and keys == sorted(k for k in port if k.startswith(prefix))
    for k in keys:
        w, g = ref[k], port[k]
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=k)
    return len(keys)


ARCH_MESH = [(m, a) for m in MESHES for a in ARCHS]
IDS = [f"{m}-{a}" for m, a in ARCH_MESH]


@pytest.mark.parametrize("mesh,arch", ARCH_MESH, ids=IDS)
def test_train_loss(runs, mesh, arch):
    assert _compare(runs, f"{mesh}-{arch}-train|out|2") == 1
    assert np.isfinite(runs["port"][f"{mesh}-{arch}-train|out|2"])


@pytest.mark.parametrize("mesh,arch", ARCH_MESH, ids=IDS)
def test_every_gradient_leaf(runs, mesh, arch):
    n = _compare(runs, f"{mesh}-{arch}-train|grad|")
    assert n == (43 if arch.startswith("deepseek") else 14)
    # the gradient is not zero: a lost psum or transpose would show
    grads = [v for k, v in runs["port"].items()
             if k.startswith(f"{mesh}-{arch}-train|grad|layers/attn")]
    assert all(np.abs(g).max() > 0 for g in grads)


@pytest.mark.parametrize("mesh,arch", ARCH_MESH, ids=IDS)
def test_updated_parameters_and_moments(runs, mesh, arch):
    assert _compare(runs, f"{mesh}-{arch}-train|out|0/") >= 14
    assert _compare(runs, f"{mesh}-{arch}-train|out|1/") >= 29


@pytest.mark.parametrize("mesh,arch", ARCH_MESH, ids=IDS)
def test_prefill_logits(runs, mesh, arch):
    assert _compare(runs, f"{mesh}-{arch}-prefill|out|") == 1


@pytest.mark.parametrize("mesh", MESHES)
def test_gqa_decode_logits_and_cache(runs, mesh):
    name = f"{mesh}-qwen3-0.6b-decode"
    assert not runs["cfgs"][name].mla
    assert _compare(runs, f"{name}|out|0") == 1
    assert _compare(runs, f"{name}|out|1/") == 4   # k, v, lens, length
    assert int(runs["port"][f"{name}|out|1/length"]) == 10
    assert _written_positions(runs, name, "0") == [9]


@pytest.mark.parametrize("mesh", MESHES)
def test_mla_flash_decode_logits_and_latent_cache(runs, mesh):
    name = f"{mesh}-deepseek-v3-671b-decode"
    cfg = runs["cfgs"][name]
    assert cfg.mla.decode_flash and cfg.mla.mesh is not None
    assert cfg.moe.mesh is not None and cfg.moe.seq_axis is None
    assert _compare(runs, f"{name}|out|0") == 1
    assert _compare(runs, f"{name}|out|1/") == 4
    # each rank wrote only the slice it owns: position 9, in the second
    # of the two sequence shards
    assert _written_positions(runs, name, "0") == [9]
    assert _written_positions(runs, name, "1") == [9]


@pytest.mark.parametrize("mesh,arch", ARCH_MESH, ids=IDS)
def test_batch1_decode_logits_and_cache(runs, mesh, arch):
    """Batch 1 on data axes of 2: no mesh fields (no flash-decoding, the
    MoE with its experts whole on every rank), the caches sharded over
    (dp, model) on the sequence, 8 positions a rank."""
    name = f"{mesh}-{arch}-decode_b1"
    cfg = runs["cfgs"][name]
    assert cfg.mesh is None
    if cfg.moe:
        assert cfg.moe.mesh is None
    if cfg.mla:
        assert not cfg.mla.decode_flash and cfg.mla.mesh is None
    assert _compare(runs, f"{name}|out|0") == 1
    assert _compare(runs, f"{name}|out|1/") == 4
    assert int(runs["port"][f"{name}|out|1/length"]) == 18
    # position 17 lies in the third of the four sequence shards
    assert _written_positions(runs, name, "0") == [17]
    assert _written_positions(runs, name, "1") == [17]


def test_the_mesh_cells_take_the_reference_branches(runs):
    for name, cfg in runs["cfgs"].items():
        if name.endswith("decode_b1"):
            continue        # the branch without mesh fields, above
        assert cfg.mesh is not None, name
        if "deepseek" in name:
            assert cfg.moe.mesh is not None and cfg.moe.ep_axis == "model"
        if name.endswith("train") or name.endswith("prefill"):
            assert cfg.tp_axis == "model", name
            if name.startswith("2x1x2"):
                assert cfg.dp_axis == ("pod", "data"), name


DISPATCH = [(64, 4, 8, 0.0), (64, 4, 3, 0.0), (50, 8, 2, 0.3),
            (33, 3, 40, 0.5), (16, 2, 1, 1.0)]


@pytest.mark.parametrize("t,n_buckets,cap,empty", DISPATCH)
def test_local_sort_dispatch_bit_for_bit(t, n_buckets, cap, empty):
    """Buckets, capacity drops and empty (-1) keys: ``buf``, ``order`` and
    ``slot`` equal the reference's."""
    rng = np.random.default_rng(t * 7 + cap)
    flat = rng.standard_normal((t, 6)).astype(np.float32)
    keys = rng.integers(0, n_buckets, t).astype(np.int32)
    keys[rng.random(t) < empty] = -1
    jb, jo, js = J_MOE._local_sort_dispatch(jnp.asarray(flat),
                                            jnp.asarray(keys), n_buckets,
                                            cap)
    tb, to, ts = T_MOE._local_sort_dispatch(torch.from_numpy(flat),
                                            torch.from_numpy(keys),
                                            n_buckets, cap)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
