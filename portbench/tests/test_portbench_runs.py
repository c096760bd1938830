"""Whole runs of a tiny cell on the host CPU: the judge passes the
program's answers and fails each fault the cell can have; the result's
last line carries the keys the contract names; the import guard stops a
run that loaded the JAX package."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests.tiny import REPO, make_root

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("tiny"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "src")]), OMP_NUM_THREADS="1",
        REPRO_TORCH_TUNING_DISABLE="1")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.tests.tiny_run", str(root),
         "ok", "stall", "half", "alter", "guard"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sound_run_is_correct_with_the_contract_keys(scenarios):
    code, result = scenarios["ok"]
    assert code == 0
    assert list(result) == KEYS
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= result["checks"]["judged"]["value"] >= 1
    assert {"qps", "latency_p95_ms", "ttfe_p95_ms", "setup_s"} <= set(
        result["metrics"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}


@pytest.mark.parametrize("fault, number", [
    ("stall", "missing"), ("half", "count_mismatch"),
    ("alter", "invalid_rows")])
def test_each_fault_makes_the_run_incorrect(scenarios, fault, number):
    code, result = scenarios[fault]
    assert code == 0
    assert result["correct"] is False
    assert result["failed"] >= 1
    c = result["checks"][number]
    assert c["value"] > c["max"]


def test_import_guard_refuses_a_run_that_loaded_the_jax_package(scenarios):
    code, result = scenarios["guard"]
    assert code != 0 and result is None


def test_run_py_exits_nonzero_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(Path(REPO) / "portbench" / "run.py"),
         "--workload", "human-q4", "--seed", "2147483649", "--seconds",
         "1", "--trace", "0"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
