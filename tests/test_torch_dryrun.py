"""The port's dry-run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.roofline``) against the JAX package's, on the CPU, with
no card and no compiler.

* qwen3-0.6b ``train_4k`` on the 16 x 16 production mesh (a fake
  256-rank group, ``meta`` tensors): rank 0's FLOPs times 256 against
  ``6 * n_active_params * tokens`` (the reference's ``model_flops``).
  The port's step does more than 6 N T, by a factor derived here from
  the config: with ``remat`` each layer's forward runs twice (8 flops a
  parameter a token, not 6, for every matrix but the embedding, the
  head's included, as the vocab-parallel NLL recomputes its chunks), and
  attention (4 S H D flops a token a layer forward, the full S x S square
  masked) runs its forward three times (the step, the layer's recompute,
  its chunks' recompute) and its backward (twice a forward) once. The
  count must be within 1.25x of that derived figure either way.
* The five LM archs' smoke train cells on a 2 x 2 mesh: the port's
  per-device FLOPs within 1.1x of the reference's ``analyze_hlo_text``
  of the same cell compiled by XLA in a subprocess (4 host devices,
  ``Auto`` axes).
* The MoE archs count all-to-all bytes; the dense ones none.
* A record's JSON keys equal the reference's, for a cell that is counted,
  for one that fails and for one stopped at its time limit.
* ``mem_per_device_bytes``: the argument shards plus the most bytes held
  at once, on a function whose lifetimes are known.
* Every non-LM cell, the paper's matcher cells included, counted on four
  fake ranks on ``meta`` (2 x 2 and 2 x 1 x 2): GNN, equivariant, DIN and
  matcher cells alike, but nequip and mace ``ogb_products`` (minutes a
  count). The matcher's loops whose condition a ``meta`` tensor cannot
  answer are counted once each as unresolved loops.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.roofline import analysis as J_AN
from repro.roofline import hlo_cost as J_HC
from repro_torch.configs import registry as T_REG
from repro_torch.configs.common import ShapeCell
from repro_torch.launch import dryrun as T_DRY
from repro_torch.launch import mesh as T_MESH
from repro_torch.launch import sharding as T_SH
from repro_torch.launch import steps as T_STEPS
from repro_torch.roofline import analysis as T_AN
from repro_torch.roofline import hlo_cost as T_HC

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = [a for a, s in T_REG.ARCHS.items() if s.family == "lm"]
SMOKE_TRAIN = dict(seq_len=16, global_batch=4)
REF_FACTOR = 1.1          # port / reference per-device FLOPs, smoke cells
DERIVED_SLACK = 1.25      # qwen3 train_4k: count against the derivation

_REFERENCE = r'''
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import registry as R
from repro.configs.common import ShapeCell
from repro.launch import steps as S
from repro.roofline.hlo_cost import analyze_hlo_text

mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for arch in sys.argv[2].split(","):
    spec = R.get_arch(arch)
    spec = dataclasses.replace(spec, config=dataclasses.replace(
        spec.smoke_config, param_dtype=jnp.float32,
        compute_dtype=jnp.float32))
    cell = S._lm_train_cell(spec, ShapeCell("train", "train",
                                            json.loads(sys.argv[3])), mesh)
    named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                   is_leaf=lambda x: isinstance(x, P))
    with mesh:
        text = jax.jit(cell.fn,
                       in_shardings=tuple(named(s) for s in cell.in_specs),
                       out_shardings=named(cell.out_specs)
                       ).lower(*cell.args).compile().as_text()
    c = analyze_hlo_text(text)
    out[arch] = {"flops": c.flops, "coll_by_kind": c.coll_by_kind}
json.dump(out, open(sys.argv[1], "w"))
'''


@pytest.fixture(scope="module")
def reference_counts(tmp_path_factory):
    """The reference's per-device counts of the smoke train cells; its
    subprocess compiles while the caller counts the port's side."""
    d = tmp_path_factory.mktemp("dryrun_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(d / "ref.json"),
         ",".join(LM_ARCHS), json.dumps(SMOKE_TRAIN)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def result() -> dict:
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, out[-3000:]
        return json.loads((d / "ref.json").read_text())
    try:
        yield result
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def port_counts(reference_counts):
    """The port's per-device counts of the same cells over a fake
    4-rank group."""
    T_MESH.init_fake_group(4)
    try:
        mesh = T_MESH.make_host_test_mesh((2, 2))
        out = {}
        for arch in LM_ARCHS:
            spec = T_REG.get_arch(arch)
            spec = dataclasses.replace(spec, config=dataclasses.replace(
                spec.smoke_config, param_dtype=torch.float32,
                compute_dtype=torch.float32))
            cell = T_STEPS.build_cell_of(
                spec, ShapeCell("train", "train", SMOKE_TRAIN), mesh)
            out[arch] = T_HC.count_run(cell.fn, *T_SH.distribute(
                cell.args, cell.in_specs, mesh))
    finally:
        dist.destroy_process_group()
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_train_flops_within_the_factor_of_the_reference(
        arch, port_counts, reference_counts):
    ref = reference_counts()[arch]["flops"]
    got = port_counts[arch].flops
    assert ref > 0 and 1 / REF_FACTOR <= got / ref <= REF_FACTOR, (got, ref)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_moe_archs_count_all_to_all_bytes(arch, port_counts,
                                          reference_counts):
    moe = T_REG.get_arch(arch).config.moe is not None
    got = port_counts[arch].coll_by_kind["all-to-all"]
    ref = reference_counts()[arch]["coll_by_kind"]["all-to-all"]
    assert (got > 0) == moe == (ref > 0), (got, ref)
    assert port_counts[arch].coll_count > 0
    assert port_counts[arch].unresolved_loops == 0


def _derived_train_flops(cfg, tokens: int, seq: int) -> float:
    """The port's train step, counted from the config: 8 flops a
    parameter a token for every matrix but the embedding (remat: the
    forward twice, the backward once), attention's forward 3 times and
    its backward once (5 forwards of 4 S H D flops a token a layer)."""
    matrices = cfg.n_active_params() - cfg.vocab * cfg.d_model
    attention = 5 * 4 * seq * cfg.n_heads * cfg.hd * cfg.n_layers
    return 8.0 * matrices * tokens + attention * tokens


def test_qwen3_train_4k_flops_on_the_production_mesh():
    spec = T_REG.get_arch("qwen3-0.6b")
    cfg, dims = spec.config, spec.shape("train_4k").dims
    assert cfg.remat and dims["seq_len"] > 1024     # both derived terms
    tokens = dims["global_batch"] * dims["seq_len"]
    model = 6.0 * cfg.n_active_params() * tokens
    assert model == _reference_model_flops("qwen3-0.6b", "train_4k")
    assert T_DRY.model_flops_of("qwen3-0.6b", "train_4k") == model
    derived = _derived_train_flops(cfg, tokens, dims["seq_len"])
    factor = derived / model
    assert 2.0 < factor < 2.2                         # the derivation's
    T_MESH.init_fake_group(256)
    try:
        mesh = T_MESH.make_production_mesh()
        cell = T_STEPS.build_cell("qwen3-0.6b", "train_4k", mesh)
        cost = T_HC.count_run(cell.fn, *T_SH.distribute(
            cell.args, cell.in_specs, mesh))
    finally:
        dist.destroy_process_group()
    got = cost.flops * 256
    assert 1 / DERIVED_SLACK <= got / derived <= DERIVED_SLACK, (
        got / model, factor)
    assert cost.coll_by_kind["all-to-all"] == 0 and cost.coll_bytes > 0


def _reference_model_flops(arch: str, shape: str) -> float:
    """The reference's ``model_flops`` (``dryrun.run_cell``'s formula)."""
    from repro.configs.registry import get_arch
    spec = get_arch(arch)
    c = spec.shape(shape)
    return 6.0 * spec.config.n_active_params() * (
        c.dims["global_batch"] * c.dims["seq_len"])


def _reference_record_keys() -> set:
    roof = J_AN.Roofline(arch="a", shape="s", mesh="m", chips=1,
                         hlo_flops=1.0, hlo_bytes=1.0, coll_bytes=1.0,
                         coll_counts={})
    return set(roof.to_dict()) | {"lower_s", "compile_s", "memory_analysis",
                                  "status"}


def test_a_record_has_the_reference_keys(tmp_path):
    rc = T_DRY.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                     "--mesh", "single", "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__pod16x16.json")
                     .read_text())
    assert set(rec) == _reference_record_keys()
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["compile_s"] is None and rec["memory_analysis"] is None
    assert 0 < rec["mem_per_device_bytes"] < T_AN.HBM_BYTES
    assert rec["hlo_flops_per_device"] > 0 and rec["model_flops"] > 0
    assert set(J_HC._COLLECTIVES) <= set(rec["coll_counts"])
    assert rec["bottleneck"] in ("compute", "memory", "collective")


def test_a_failed_cell_is_recorded_and_the_run_exits_1(tmp_path):
    rc = T_DRY.main(["--arch", "qwen3-0.6b", "--shape", "no_such_shape",
                     "--mesh", "multi", "--out", str(tmp_path)])
    assert rc == 1
    rec = json.loads((tmp_path / "qwen3-0.6b__no_such_shape__pod2x16x16"
                      ".json").read_text())
    assert set(rec) == {"arch", "shape", "multi_pod", "status", "error"}
    assert rec["status"] == "fail" and rec["multi_pod"] is True


def test_a_cell_past_its_time_limit_is_recorded_as_failed(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(T_DRY, "CELL_TIMEOUT_S", 0.001)
    rc = T_DRY.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                     "--mesh", "single", "--out", str(tmp_path)])
    assert rc == 1
    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__pod16x16.json")
                     .read_text())
    assert set(rec) == {"arch", "shape", "multi_pod", "status", "error"}
    assert rec["status"] == "fail" and "TimeoutError" in rec["error"]


def test_memory_per_device_is_the_shards_and_the_most_held():
    mib = 1 << 20
    x = torch.empty(mib // 4, device="meta")      # 1 MiB of float32

    def kept_by_a_view(x):
        y = x * 2                  # 1 MiB
        v = y.view(-1, 4)
        del y                      # its block lives on in the view
        return torch.cat([v, v])   # 2 MiB: x, y's block and this

    def freed(x):
        y = x * 2                  # 1 MiB
        del y                      # freed with its last tensor
        return torch.cat([x, x])   # 2 MiB: x and this

    assert T_HC.count_run(kept_by_a_view, x).peak_bytes == 4 * mib
    assert T_HC.count_run(freed, x).peak_bytes == 3 * mib


def test_the_cli_is_the_reference_cli():
    # the reference module sets XLA_FLAGS when imported: read its source
    ref = (ROOT / "src/repro/launch/dryrun.py").read_text()
    for flag in ("--arch", "--shape", "--all", "--mesh", "--include-matcher",
                 "--out", "--skip-existing"):
        assert f'"{flag}"' in ref and flag in T_DRY.main.__code__.co_consts


def test_roofline_terms_and_keys():
    cost = T_HC.HloCost(flops=989e12, bytes=3.35e12 * 2, coll_bytes=450e9)
    roof = T_AN.analyze("a", "s", "pod16x16", 256, cost, model_flops=256e12)
    assert math.isclose(roof.t_compute, 1.0)
    assert math.isclose(roof.t_memory, 2.0)
    assert math.isclose(roof.t_collective, 1.0)
    assert roof.bottleneck == "memory"
    assert math.isclose(roof.useful_flops_frac, 256e12 / (989e12 * 256))
    ref = J_AN.Roofline(arch="a", shape="s", mesh="m", chips=1,
                        hlo_flops=1.0, hlo_bytes=1.0, coll_bytes=1.0,
                        coll_counts={})
    assert list(roof.to_dict()) == list(ref.to_dict())
    assert {f.name for f in dataclasses.fields(J_HC.HloCost)} <= {
        f.name for f in dataclasses.fields(T_HC.HloCost)}
    # an H100 SXM5's, not a TPU's
    assert (T_AN.PEAK_FLOPS, T_AN.HBM_BW, T_AN.LINK_BW) == (989e12, 3.35e12,
                                                           450e9)


HOST_MESHES = {"2x2": ((2, 2), ("data", "model")),
               "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
NON_LM = [(a, c) for a, c in T_REG.all_cells(include_matcher=True)
          if T_REG.ARCHS[a].family != "lm"
          and not (a in ("nequip", "mace") and c == "ogb_products")]
COUNT_LIMIT_S = 300


def _count_on_four_ranks(mesh_name: str, arch: str, shape: str):
    T_MESH.init_fake_group(4)
    try:
        mesh = T_MESH.make_host_test_mesh(*HOST_MESHES[mesh_name])
        cell = T_STEPS.build_cell(arch, shape, mesh)
        args = T_SH.distribute(cell.args, cell.in_specs, mesh)
        with T_DRY.time_limit(COUNT_LIMIT_S):
            return T_HC.count_run(cell.fn, *args)
    finally:
        dist.destroy_process_group()


NON_LM_IDS = [(m, a, c) for m in HOST_MESHES for a, c in NON_LM]


@pytest.mark.parametrize("mesh_name,arch,shape", NON_LM_IDS,
                         ids=[f"{m}-{a}-{c}" for m, a, c in NON_LM_IDS])
def test_every_non_lm_cell_counts_on_four_ranks(mesh_name, arch, shape):
    cost = _count_on_four_ranks(mesh_name, arch, shape)
    assert cost.flops > 0 and cost.bytes > 0 and cost.peak_bytes > 0
    assert cost.coll_bytes > 0          # the lanes and gradients cross
    if arch == "paper-matcher":
        # the split refine's partial words gathered over "model"
        assert cost.coll_by_kind["all-gather"] > 0


def test_the_stack_cell_counts_its_loops_as_unresolved():
    """The megastep's condition, its drain's and the store's insert
    rounds are read back to the host: on ``meta`` each body is counted
    once, an unresolved loop each; the wave cell has no such loop."""
    stacks = _count_on_four_ranks("2x2", "paper-matcher",
                                  "yeast_scale_stacks")
    wave = _count_on_four_ranks("2x2", "paper-matcher", "yeast_scale")
    assert stacks.unresolved_loops >= 1 and wave.unresolved_loops == 0
    assert stacks.flops > wave.flops > 0


def test_a_loop_condition_reads_values_and_counts_meta_once():
    assert T_HC.loop_condition(torch.tensor(True), False) is True
    assert T_HC.loop_bound(torch.tensor(7)) == 7
    cond = torch.empty((), dtype=torch.bool, device="meta")
    seen = []

    def loop(x):
        i = 0
        while T_HC.loop_condition(cond, i == 0):
            seen.append(i)
            x = x + 1
            i += 1
        return x * T_HC.loop_bound(torch.empty((), dtype=torch.int64,
                                               device="meta"))
    cost = T_HC.count_run(loop, torch.empty(8, device="meta"))
    assert seen == [0] and cost.unresolved_loops == 2
    assert cost.flops == 16
