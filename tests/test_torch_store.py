"""The port's hashed Δ store (``repro_torch.patterns.store``) against the
JAX package's, lane for lane.

Congested random batches (same-key duplicates, probe windows filled so
entries evict, in-batch conflicts that need all three insert rounds) go
through both ``hash_insert``s from the same bank; every bank lane and
every ``StoreCounters`` lane must then be equal, and so must every
``hash_probe`` result. Entries dicts written by the JAX package load
through ``repro_torch.convert`` and probe identically. Inputs come from
numpy with a seed. All lanes are integer or bitmap: comparisons are
exact (no tolerance).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.patterns import cache as jcache
from repro.patterns import store as js
from repro_torch import convert
from repro_torch.patterns import store as ts

torch.set_num_threads(1)

N_SLOTS = 3


def _batch(rng, n, n_keys, capacity):
    """Flat insert batch drawn from a small key space (duplicates and
    shared probe windows), masks using both words and bit 31."""
    kid = rng.integers(0, n_keys, n)
    key_pos = (kid % 7).astype(np.int32)
    key_v = (kid * 37 % 1009).astype(np.int32)
    slot = rng.integers(0, N_SLOTS, n).astype(np.int32)
    phis = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    mus = rng.integers(0, 9, n).astype(np.int32)
    masks = rng.integers(0, 2**32, (n, js.MASK_WORDS),
                         dtype=np.uint64).astype(np.uint32)
    valid = rng.random(n) < 0.9
    return slot, key_pos, key_v, phis, mus, masks, valid


def _jax_args(b):
    return [jnp.asarray(a) for a in b]


def _torch_args(b):
    return [torch.from_numpy(convert.as_int32(a).copy()) for a in b]


def _assert_bank_equal(jb, tb, where):
    got = convert.to_numpy(tb)
    for k in js.PatternStoreBank._fields:
        np.testing.assert_array_equal(
            got[k], convert.as_int32(np.asarray(getattr(jb, k))),
            err_msg=f"{where}: bank lane {k}")


def _assert_counters_equal(jc, tc, where):
    for k in js.StoreCounters._fields:
        np.testing.assert_array_equal(
            getattr(tc, k).numpy(), np.asarray(getattr(jc, k)),
            err_msg=f"{where}: counter {k}")


@pytest.mark.parametrize("capacity,n_keys,seed", [
    (8, 40, 0), (16, 200, 1), (64, 500, 3)])
def test_hash_insert_and_probe_match_reference(monkeypatch, capacity,
                                               n_keys, seed):
    rounds = []
    real_round = ts._insert_round

    def counting_round(*a):
        rounds[-1] += 1
        return real_round(*a)
    monkeypatch.setattr(ts, "_insert_round", counting_round)

    rng = np.random.default_rng(seed)
    jb = js.PatternStoreBank.empty(N_SLOTS, capacity)
    tb = ts.PatternStoreBank.empty(N_SLOTS, capacity, "cpu")
    for step in range(4):
        b = _batch(rng, 96, n_keys, capacity)
        rounds.append(0)
        jb, jc = js.hash_insert(jb, *_jax_args(b))
        tb, tc = ts.hash_insert(tb, *_torch_args(b))
        where = f"cap={capacity} step={step}"
        _assert_bank_equal(jb, tb, where)
        _assert_counters_equal(jc, tc, where)
        # random hit counters make eviction pick by counter, not slot
        hits = rng.integers(0, 50, (N_SLOTS, capacity)).astype(np.int32)
        jb = jb._replace(hits=jnp.asarray(hits))
        tb.hits.copy_(torch.from_numpy(hits))
        if step % 2:
            jb = js.age_hits(jb)
            ts.age_hits(tb)
            _assert_bank_equal(jb, tb, where + " aged")
        # probes: half the keys stored, half fresh
        pb = _batch(rng, 64, 2 * n_keys, capacity)
        got = ts.hash_probe(tb, *_torch_args(pb[:3]))
        want = js.hash_probe(jb, *_jax_args(pb[:3]))
        for name, g, w in zip(("found", "phi", "mu", "mask", "idx"),
                              got, want):
            np.testing.assert_array_equal(
                g.numpy(), convert.as_int32(np.asarray(w)),
                err_msg=f"{where}: probe {name}")
    if capacity <= 16:
        assert max(rounds) == ts.INSERT_ROUNDS


def test_congested_batch_evicts_and_drops():
    """A batch far larger than the windows: evictions and drops happen,
    on both sides alike."""
    rng = np.random.default_rng(7)
    b = _batch(rng, 400, 300, 8)
    jb, jc = js.hash_insert(js.PatternStoreBank.empty(N_SLOTS, 8),
                            *_jax_args(b))
    tb, tc = ts.hash_insert(ts.PatternStoreBank.empty(N_SLOTS, 8, "cpu"),
                            *_torch_args(b))
    _assert_bank_equal(jb, tb, "congested")
    _assert_counters_equal(jc, tc, "congested")
    b2 = _batch(rng, 400, 300, 8)
    jb, jc = js.hash_insert(jb, *_jax_args(b2))
    tb, tc = ts.hash_insert(tb, *_torch_args(b2))
    _assert_bank_equal(jb, tb, "congested, second batch")
    _assert_counters_equal(jc, tc, "congested, second batch")
    assert int(tc.evictions.sum()) > 0
    assert int(tc.dropped.sum()) > 0


def _filled_jax_bank(seed, capacity=32):
    rng = np.random.default_rng(seed)
    jb = js.PatternStoreBank.empty(N_SLOTS, capacity)
    jb, _ = js.hash_insert(jb, *_jax_args(_batch(rng, 120, 90, capacity)))
    hits = rng.integers(0, 20, (N_SLOTS, capacity)).astype(np.int32)
    return jb._replace(hits=jnp.asarray(hits)), rng


@pytest.mark.parametrize("capacity", [16, 64])
def test_jax_entries_load_through_convert_and_probe_identically(capacity):
    jb, rng = _filled_jax_bank(0)
    jstore = js.PatternStore(*(lane[1] for lane in jb))
    entries = js.store_to_entries(jstore)
    seed = convert.entries(entries)
    got = ts.entries_to_store(seed, capacity, "cpu")
    want = js.entries_to_store(entries, capacity)
    for k in js.PatternStore._fields:
        np.testing.assert_array_equal(
            getattr(got, k).numpy(),
            convert.as_int32(np.asarray(getattr(want, k))),
            err_msg=f"entries_to_store lane {k}")
    # the port's snapshot of that store is the reference's entries dict
    back = ts.store_to_entries(got)
    ref_back = js.store_to_entries(want)
    for k in ts.ENTRY_KEYS:
        np.testing.assert_array_equal(back[k], ref_back[k])
    # probing a one-slot bank of it: same answers as the reference
    tbank = ts.PatternStoreBank(*(lane[None] for lane in got))
    jbank = js.PatternStoreBank(*(lane[None] for lane in want))
    pb = _batch(rng, 80, 90, capacity)
    zero = np.zeros(80, np.int32)
    t_out = ts.hash_probe(tbank, torch.from_numpy(zero),
                          *_torch_args(pb[1:3]))
    j_out = js.hash_probe(jbank, jnp.asarray(zero), *_jax_args(pb[1:3]))
    for g, w in zip(t_out, j_out):
        np.testing.assert_array_equal(g.numpy(),
                                      convert.as_int32(np.asarray(w)))
    assert bool(t_out[0].any())


def test_pattern_cache_line_seeds_the_port():
    """A JAX PatternCache line (selected μ == 0 entries) becomes the
    port's seed_patterns and loads into the same store."""
    jb, _ = _filled_jax_bank(1)
    entries = js.store_to_entries(js.PatternStore(*(lane[0] for lane in jb)))
    entries["mu"][: len(entries["mu"]) // 2] = 0
    cache = jcache.PatternCache(max_templates=4, top_k=8)
    cache.put(b"fp", entries)
    line = cache.get(b"fp")
    assert line is not None and len(line["pos"]) > 0
    seed = convert.entries(line)
    np.testing.assert_array_equal(
        ts.select_entries(seed, 8)["pos"], js.select_entries(line, 8)["pos"])
    got = ts.entries_to_store(seed, 32, "cpu")
    want = js.entries_to_store(line, 32)
    for k in js.PatternStore._fields:
        np.testing.assert_array_equal(
            getattr(got, k).numpy(),
            convert.as_int32(np.asarray(getattr(want, k))))


def test_convert_store_bank_round_trip():
    jb, _ = _filled_jax_bank(2)
    tb = convert.store_bank(jb, "cpu")
    _assert_bank_equal(jb, tb, "convert.store_bank")
    assert tb.mask.dtype == torch.int32 and tb.valid.dtype == torch.bool
