"""The frozen generator and the dataset cache."""
import json
import shutil

import numpy as np
import pytest

from portbench.datasets import cache
from portbench.tests.tiny import CONFIG, HERE


def test_cached_and_fresh_builds_are_equal(tmp_path):
    fresh = cache.build(CONFIG["graph"])
    first, built = cache.load("tiny", CONFIG["graph"], tmp_path)
    again, built_again = cache.load("tiny", CONFIG["graph"], tmp_path)
    assert built and not built_again
    for arrays in (first, again):
        assert arrays["n"] == fresh["n"]
        assert arrays["n_labels"] == fresh["n_labels"]
        for k in ("labels", "indptr", "indices"):
            np.testing.assert_array_equal(arrays[k], fresh[k])


def test_the_digest_covers_the_generator_source(tmp_path):
    copy = tmp_path / "datasets"
    shutil.copytree(HERE / "datasets", copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = cache.digest(CONFIG["graph"], copy)
    assert before == cache.digest(CONFIG["graph"])
    with open(copy / "attachment_graph.py", "a") as f:
        f.write("\n# changed\n")
    assert cache.digest(CONFIG["graph"], copy) != before
    other = dict(CONFIG["graph"], seed=CONFIG["graph"]["seed"] + 1)
    assert cache.digest(other) != before


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (HERE / "configs").glob("*.json")))
def test_built_graphs_have_the_stated_sizes(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    g = cache.build(cfg["graph"])
    ds = cfg["dataset"]
    assert g["n"] == ds["n_vertices"]
    assert len(g["indices"]) == 2 * ds["n_edges"]
    assert len(np.unique(g["labels"])) == ds["n_labels"] == g["n_labels"]
    deg = np.diff(g["indptr"])
    rows = np.repeat(np.arange(g["n"]), deg)
    assert (rows != g["indices"]).all()                  # no self loops
    key = rows.astype(np.int64) * g["n"] + g["indices"]
    assert (np.diff(key) > 0).all()                      # sorted, distinct
    assert deg.max() > 5 * deg.mean()                    # heavy tail
