"""The control, at a size a test run holds: the reference with the
edge guarantee broken must fail the judge on every seed, and the plain
reference must pass it."""
import pytest

from portbench import control
from portbench.datasets import cache
from portbench.harness import judge, passes
from portbench.queries import query_pool
from portbench.reference.match import DataGraph, enumerate_embeddings
from portbench.tests.tiny import CONFIG, TRAFFIC, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 3000000019])
def test_the_control_fails_the_judge(root, seed):
    r = control.run_control("tiny-t5", seed, root=root)
    assert r["passed"] is False
    assert r["checks"]["invalid_rows"]["value"] > 0


def test_the_plain_reference_passes_the_judge(root):
    arrays, _ = cache.load("tiny", CONFIG["graph"],
                           root / "portbench" / ".cache")
    g = DataGraph.of(arrays)
    qs = query_pool(g, TRAFFIC["query_vertices"], 40, 3000000019)
    limit = CONFIG["limit"]
    answers = []
    for i, q in enumerate(qs):
        n, rows = enumerate_embeddings(q, g, limit, keep=True)
        answers.append((i, "limit" if n >= limit else "ok", n, rows))
    checks, failed = judge(answers, qs, g, limit, missing=0)
    assert passes(checks) and failed == 0
