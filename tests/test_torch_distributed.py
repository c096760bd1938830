"""The port's distributed matcher (``repro_torch.core.distributed``) on
the CPU.

One port case for each test of ``tests/test_distributed.py`` with the
same assertions, on the port's own generators and sequential oracle;
then the two packages side by side: a ``state.npz`` written mid-run by
either package restores in the other with the writer's final embedding
set and φ floor, both packages write the same checkpoint for the same
run (keys, dtypes and values), and ``select_exchange_patterns`` picks
the same entries bit for bit. The JAX side runs with
``REPRO_TUNING_DISABLE=1`` so both sides use the built-in knobs.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core.backtrack import _prepare, backtrack_deadend
from repro_torch.core.distributed import (CHECKPOINT_VERSION,
                                          DistributedMatcher,
                                          select_exchange_patterns)
from repro_torch.core.engine_step import N_PAD
from repro_torch.core.vectorized import WaveEngine
from repro_torch.data.graph_gen import (er_labeled_graph,
                                        random_walk_query, trap_graph)
from repro_torch.patterns.store import words_from64

torch.set_num_threads(1)

# deadend_prunes of the reference's old per-engine matcher on trap(40)
# with n_shards=4, wave_size=32, kpr=4 (tests/test_distributed.py)
OLD_PER_ENGINE_TRAP40_PRUNES = 1320
KNOBS = dict(wave_size=32, kpr=4, device="cpu")


def embset(embs):
    return set(frozenset(enumerate(np.asarray(e).tolist())) for e in embs)


def matcher(data, **kw):
    return DistributedMatcher(data, **{**KNOBS, **kw})


@pytest.fixture(scope="module")
def trap40():
    query, data = trap_graph(n_b=40, n_c=40, n_good=2, tail_len=2, seed=0)
    return query, data, backtrack_deadend(query, data, limit=None)


@pytest.fixture(scope="module")
def trap20():
    query, data = trap_graph(n_b=20, n_c=20, n_good=2, tail_len=2, seed=0)
    return query, data, backtrack_deadend(query, data, limit=None)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_distributed_matches_sequential(n_shards):
    data = er_labeled_graph(40, 130, 2, seed=2)
    query = random_walk_query(data, 4, seed=3)
    ref = backtrack_deadend(query, data, limit=None)
    res = matcher(data, n_shards=n_shards).match(query, limit=None)
    assert embset(res.embeddings) == embset(ref.embeddings)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_distributed_megastep_matches_sequential(n_shards, trap20):
    data = er_labeled_graph(40, 130, 2, seed=2)
    query = random_walk_query(data, 4, seed=3)
    tq, tg, _ = trap20
    for q, g in ((query, data), (tq, tg)):
        ref = backtrack_deadend(q, g, limit=None)
        dm = matcher(g, n_shards=n_shards, megastep_depth=4,
                     adaptive_prune_threshold=2.0)
        res = dm.match(q, limit=None)
        assert embset(res.embeddings) == embset(ref.embeddings)


def test_full_delta_sharing_observable_on_trap(trap40):
    query, data, ref = trap40
    res = matcher(data, n_shards=4).match(query, limit=None)
    assert embset(res.embeddings) == embset(ref.embeddings)
    assert res.stats.deadend_prunes >= OLD_PER_ENGINE_TRAP40_PRUNES
    single = WaveEngine(data, **KNOBS).match(query, limit=None)
    assert res.stats.deadend_prunes >= 0.95 * single.stats.deadend_prunes
    d_rate = res.stats.deadend_prunes / max(1, res.stats.rows_created)
    s_rate = single.stats.deadend_prunes / max(1, single.stats.rows_created)
    assert d_rate >= 0.9 * s_rate


def test_sharing_beats_isolated_shards(trap40):
    query, data, _ = trap40
    r1 = matcher(data, n_shards=4, share_patterns=True).match(
        query, limit=None)
    r2 = matcher(data, n_shards=4, share_patterns=False).match(
        query, limit=None)
    assert embset(r1.embeddings) == embset(r2.embeddings)
    assert r1.stats.deadend_prunes >= r2.stats.deadend_prunes
    assert r1.stats.rows_created <= r2.stats.rows_created


def test_work_stealing_mid_query(trap40):
    query, data, ref = trap40
    dm = DistributedMatcher(data, n_shards=8, wave_size=16, kpr=4,
                            device="cpu")
    res = dm.match(query, limit=None)
    assert embset(res.embeddings) == embset(ref.embeddings)
    assert res.stats.steals > 0
    assert res.stats.shard_rows is not None
    assert len(res.stats.shard_rows) == 8
    assert sum(res.stats.shard_rows) == res.stats.rows_created


def test_checkpoint_npz_roundtrip(tmp_path, trap20):
    query, data, ref = trap20
    dm = matcher(data, n_shards=4, checkpoint_every_waves=2)
    res = dm.match(query, limit=None, checkpoint_dir=str(tmp_path))
    assert embset(res.embeddings) == embset(ref.embeddings)
    assert (tmp_path / "state.npz").exists()
    ck = DistributedMatcher.load_state(str(tmp_path))
    assert ck.version == 3
    assert len(ck.pending_roots) == 0
    assert embset(ck.embeddings) == embset(ref.embeddings)
    assert ck.entries is not None and len(ck.entries["pos"]) > 0
    assert ck.entries["hits"].sum() > 0
    assert ck.phi_floor > 1


def _abort_mid_run(data, query, path):
    dm = matcher(data, n_shards=4, checkpoint_every_waves=2)
    partial = dm.match(query, limit=None, checkpoint_dir=str(path),
                       max_rows=120)
    assert partial.stats.aborted and partial.stats.abort_reason == "rows"
    return DistributedMatcher.load_state(str(path))


def test_elastic_restore_onto_different_shard_count(tmp_path, trap40):
    query, data, ref = trap40
    ck = _abort_mid_run(data, query, tmp_path)
    assert len(ck.pending_roots) > 0
    dm2 = matcher(data, n_shards=3)
    res = dm2.match(query, limit=None, checkpoint_dir=str(tmp_path),
                    resume=True)
    assert embset(res.embeddings) == embset(ref.embeddings)
    assert dm2.scheduler.pool.id_counter >= ck.phi_floor


def test_resume_with_limit_yields_full_quota(tmp_path, trap40):
    query, data, ref = trap40
    n_full = len(ref.embeddings)
    assert n_full > 20
    _abort_mid_run(data, query, tmp_path)
    dm2 = matcher(data, n_shards=2)
    res = dm2.match(query, limit=n_full - 5, checkpoint_dir=str(tmp_path),
                    resume=True)
    assert res.stats.found == n_full - 5
    assert embset(res.embeddings) <= embset(ref.embeddings)
    assert len(embset(res.embeddings)) == n_full - 5


def test_legacy_json_checkpoint_read_path(tmp_path, trap20):
    query, data, ref = trap20
    cand_by_pos, _, _, _ = _prepare(query, data, None, None)
    n_roots = len(cand_by_pos[0])
    state = {"shards": [
        {"shard_id": 0, "pending": [[0, n_roots // 2]], "found": []},
        {"shard_id": 1, "pending": [[n_roots // 2, n_roots]], "found": []},
    ]}
    pathlib.Path(tmp_path, "state.json").write_text(json.dumps(state))
    dm = matcher(data, n_shards=3)
    res = dm.match(query, limit=None, checkpoint_dir=str(tmp_path),
                   resume=True)
    assert embset(res.embeddings) == embset(ref.embeddings)


def test_exchange_selection_deterministic_by_hits(trap40):
    query, data, _ = trap40

    def run():
        dm = matcher(data, n_shards=4)
        dm.match(query, limit=None)
        return dm

    dm1, dm2 = run(), run()
    e1 = dm1.export_patterns(top_k=8, transferable_only=False)
    e2 = dm2.export_patterns(top_k=8, transferable_only=False)
    assert np.array_equal(e1["pos"], e2["pos"])
    assert np.array_equal(e1["v"], e2["v"])
    assert len(e1["pos"]) == 8
    full = dm1._entries
    exported = set(zip(e1["pos"].tolist(), e1["v"].tolist()))
    excluded_hits = [int(h) for p, v, h in zip(
        full["pos"].tolist(), full["v"].tolist(), full["hits"].tolist())
        if (p, v) not in exported]
    if excluded_hits:
        assert int(e1["hits"].min()) >= max(excluded_hits)


def test_exchange_transferable_only_filters_mu(trap40):
    query, data, _ = trap40
    dm = matcher(data, n_shards=4)
    dm.match(query, limit=None)
    tab = dm.export_patterns(transferable_only=True)
    assert (np.asarray(tab["mu"]) == 0).all()
    full = dm.export_patterns(transferable_only=False)
    assert len(full["pos"]) >= len(tab["pos"])
    assert len(full["pos"]) == len(dm._entries["pos"])


def test_legacy_v2_dense_checkpoint_read_path(tmp_path, trap40):
    query, data, ref = trap40
    ck = _abort_mid_run(data, query, tmp_path)
    assert ck.entries is not None and len(ck.entries["pos"]) > 0
    v = data.n
    dense = {k: np.zeros((N_PAD, v), d) for k, d in
             (("phi", np.int32), ("mu", np.int32), ("valid", bool))}
    dense["mask"] = np.zeros((N_PAD, v, 2), np.uint32)
    hits = np.zeros((N_PAD, v), np.int64)
    e = ck.entries
    dense["phi"][e["pos"], e["v"]] = e["phi"]
    dense["mu"][e["pos"], e["v"]] = e["mu"]
    dense["mask"][e["pos"], e["v"]] = words_from64(e["mask"])
    dense["valid"][e["pos"], e["v"]] = True
    hits[e["pos"], e["v"]] = e["hits"]
    payload = {"version": np.int64(2), "n_shards": np.int64(4),
               "phi_floor": np.int64(ck.phi_floor),
               "pending_roots": ck.pending_roots,
               "embeddings": (np.stack(ck.embeddings).astype(np.int32)
                              if ck.embeddings
                              else np.zeros((0, 0), np.int32)),
               "table_hits": hits}
    for k in ("phi", "mu", "mask", "valid"):
        payload[f"table_{k}"] = dense[k]
    with open(tmp_path / "state.npz", "wb") as f:
        np.savez_compressed(f, **payload)
    ck2 = DistributedMatcher.load_state(str(tmp_path))
    assert ck2.version == 2
    for k in ("pos", "v", "phi", "mu", "mask", "hits"):
        np.testing.assert_array_equal(ck2.entries[k], ck.entries[k])
    dm2 = matcher(data, n_shards=3)
    res = dm2.match(query, limit=None, checkpoint_dir=str(tmp_path),
                    resume=True)
    assert embset(res.embeddings) == embset(ref.embeddings)
    assert dm2.scheduler.pool.id_counter >= ck.phi_floor


# ----------------------------------------------------------------------
# the two packages side by side
# ----------------------------------------------------------------------
def _jax_trap40():
    from repro.data.graph_gen import trap_graph as jtrap
    return jtrap(n_b=40, n_c=40, n_good=2, tail_len=2, seed=0)


def _jax_matcher(data, **kw):
    from repro.core.distributed import DistributedMatcher as JaxMatcher
    return JaxMatcher(data, wave_size=32, kpr=4, **kw)


def _npz(path):
    with np.load(pathlib.Path(path) / "state.npz") as z:
        return {k: z[k] for k in z.files}


def _write_mid_run(package, data, query, path):
    """Abort a 4-shard checkpointed run at 120 rows in ``package``."""
    make = _jax_matcher if package == "jax" else (
        lambda d, **kw: matcher(d, **kw))
    dm = make(data, n_shards=4, checkpoint_every_waves=2)
    partial = dm.match(query, limit=None, checkpoint_dir=str(path),
                       max_rows=120)
    assert partial.stats.aborted and partial.stats.abort_reason == "rows"


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_across_packages(monkeypatch, tmp_path,
                                             writer):
    """A mid-run ``state.npz`` written by one package resumes in the
    other (on 3 shards) with the same final embedding set as a resume
    in the writer itself, and the reader raises its φ floor to the
    writer's ceiling."""
    from repro.core.distributed import DistributedMatcher as JaxMatcher
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    query, data = _jax_trap40()
    _write_mid_run(writer, data, query, tmp_path)
    ck_j = JaxMatcher.load_state(str(tmp_path))
    ck_t = DistributedMatcher.load_state(str(tmp_path))
    assert ck_t.version == ck_j.version == CHECKPOINT_VERSION
    assert ck_t.phi_floor == ck_j.phi_floor > 1
    assert len(ck_t.pending_roots) > 0
    np.testing.assert_array_equal(ck_t.pending_roots, ck_j.pending_roots)
    for k in ck_j.entries:
        np.testing.assert_array_equal(ck_t.entries[k], ck_j.entries[k])
    ckpt = _npz(tmp_path)
    res_j = _jax_matcher(data, n_shards=3).match(
        query, limit=None, checkpoint_dir=str(tmp_path), resume=True)
    (tmp_path / "state.npz").unlink()
    np.savez_compressed(tmp_path / "state.npz", **ckpt)
    dm_t = matcher(data, n_shards=3)
    res_t = dm_t.match(query, limit=None, checkpoint_dir=str(tmp_path),
                       resume=True)
    assert embset(res_t.embeddings) == embset(res_j.embeddings)
    oracle = backtrack_deadend(query, data, limit=None)
    assert embset(res_t.embeddings) == embset(oracle.embeddings)
    assert dm_t.scheduler.pool.id_counter >= ck_j.phi_floor


def test_both_packages_write_the_same_checkpoint(monkeypatch, tmp_path):
    """The same aborted run writes the same ``state.npz`` in both
    packages: the same keys, dtypes and shapes, and the same values."""
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    query, data = _jax_trap40()
    _write_mid_run("jax", data, query, tmp_path / "jax")
    _write_mid_run("torch", data, query, tmp_path / "torch")
    want, got = _npz(tmp_path / "jax"), _npz(tmp_path / "torch")
    assert sorted(got) == sorted(want)
    assert "delta_pos" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_exchange_selection_equals_the_reference(monkeypatch):
    """``select_exchange_patterns`` of both packages on the same entries
    (a full Δ export of a trap run, hit counters included) picks the
    same entries, bit for bit, at every cap."""
    from repro.core.distributed import select_exchange_patterns as jsel
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    query, data = _jax_trap40()
    dm = _jax_matcher(data, n_shards=4)
    dm.match(query, limit=None)
    entries = dm.export_patterns(top_k=None, transferable_only=False)
    assert len(entries["pos"]) > 8 and entries["hits"].sum() > 0
    for top_k in (0, 1, 8, len(entries["pos"]) // 2, None):
        for transferable in (True, False):
            want = jsel(entries, top_k, transferable_only=transferable)
            got = select_exchange_patterns(
                entries, top_k, transferable_only=transferable)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes(), (top_k, k)
