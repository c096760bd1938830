"""The port's tuning layer (``repro_torch.tuning`` and the layout-knob
resolution in ``repro_torch.kernels.config``) on the CPU.

Two parts:

* one port case for each test of ``tests/test_tuning.py``, with the
  same assertions where the rule is the same: search-space validity
  (Hopper's shared-memory and device-memory budgets in place of the
  VMEM one, no ``block_f`` tiling rule), cache round-trip and staleness,
  the resolution order (explicit > record > built-in, scope override >
  record), a consumed record surfacing in ``scheduler_stats()``, and
  the weird-config oracle pin;
* differential checks against ``repro.tuning``: the same verdict on
  points no budget rule decides, the same knobs / ``filled_from_cache``
  / descriptor keys for the same record, the same smoke-workload
  digest, and neither package's cache file or variables moving the
  other. Both packages' caches point at ``tmp_path`` files (or are
  disabled) wherever the reference resolves knobs: the repo's
  ``TUNING_CACHE.json`` holds a record for 65–128-vertex graphs.
"""
import json

import numpy as np
import pytest
import torch

from repro.api.options import MatchOptions as RefOptions
from repro.core.backtrack import backtrack_deadend as ref_backtrack
from repro.core.graph import Graph as RefGraph
from repro.tuning import TuningCache as RefCache
from repro.tuning import device_kind as ref_device_kind
from repro.tuning import resolve_engine_options as ref_resolve
from repro.tuning.space import CandidateConfig as RefConfig
from repro.tuning.space import TunableSpace as RefSpace
from repro.tuning.space import WorkloadShape as RefShape
from repro_torch.api.options import ENGINE_TUNABLE_DEFAULTS, MatchOptions
from repro_torch.core.vectorized import WaveScheduler
from repro_torch.data.graph_gen import (corridor_graph, er_labeled_graph,
                                        random_walk_query, trap_graph)
from repro_torch.kernels import config as kconfig
from repro_torch.tuning import (CandidateConfig, TunableSpace, TuningCache,
                                WorkloadShape, cache_key, device_kind,
                                quantize_vertices, resolve_engine_options,
                                schema_hash)
from repro_torch.tuning import cache as tcache
from repro_torch.tuning.space import (DEFAULT_DENSE_BUDGET_BYTES,
                                      HOPPER_SMEM_OPTIN_BYTES, PROBE,
                                      dense_adjacency_bytes,
                                      hier_refine_smem_bytes)

torch.set_num_threads(1)

CPU = torch.device("cpu")
DESCRIPTOR_KEYS = {"source", "record", "key", "schema_hash", "backend",
                   "v_bucket", "filled_from_cache", "params"}


def embset(embeddings):
    return set(frozenset(enumerate(np.asarray(e).tolist()))
               for e in embeddings)


def oracle(q, data, limit=None):
    """The reference's sequential oracle (``repro.core.backtrack``) on
    the same graphs."""
    def ref(g):
        return RefGraph(g.n, g.labels, g.indptr, g.indices, g.n_labels)
    return ref_backtrack(ref(q), ref(data), limit=limit)


@pytest.fixture(autouse=True)
def _no_ambient_cache(monkeypatch, tmp_path):
    """Every test starts from an empty port cache and the tuning layer
    on, whatever the environment says."""
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE",
                       str(tmp_path / "empty_torch_cache.json"))
    monkeypatch.delenv("REPRO_TORCH_TUNING_DISABLE", raising=False)


# --------------------------------------------------------- search space
def test_probe_pin_matches_pattern_store():
    from repro_torch.patterns.store import PROBE as STORE_PROBE
    assert PROBE == STORE_PROBE


def test_space_rejects_invalid_points_before_launch():
    """Every constraint fires as a reason string from pure shape
    arithmetic; the budgets are Hopper's."""
    shape = WorkloadShape.for_graph(128)
    space = TunableSpace("torch", shape)
    assert space.validate(CandidateConfig()) is None

    r = space.validate(CandidateConfig(wave_size=48))
    assert r is not None and "power of two" in r
    r = space.validate(CandidateConfig(pattern_capacity=4))
    assert r is not None and "probe window" in r
    r = space.validate(CandidateConfig(stack_capacity=256, wave_size=512))
    assert r is not None and "stack_capacity" in r
    r = space.validate(CandidateConfig(megastep_depth=0))
    assert r is not None and ">= 1" in r

    assert space.validate(CandidateConfig(chunk_words=1)) is None
    r = space.validate(CandidateConfig(chunk_words=3))
    assert r is not None and "chunk_words" in r and "power of two" in r
    r = space.validate(CandidateConfig(chunk_words=256))
    assert r is not None and "chunk_words" in r
    r = space.validate(CandidateConfig(dma_depth=0))
    assert r is not None and ">= 1" in r
    r = space.validate(CandidateConfig(hbm_adjacency=2))
    assert r is not None and "hbm_adjacency" in r

    # no block_f tiling rule: no CUDA refine reads block_f
    odd = CandidateConfig(block_f=12)
    for backend in ("cuda", "torch"):
        assert TunableSpace(backend, shape, smem_limit_bytes=1 << 20,
                            dense_budget_bytes=1 << 30
                            ).validate(odd) is None

    # dense budget: a graph whose [V, W] block alone exceeds the
    # device-memory budget is rejected with the byte arithmetic ...
    big = WorkloadShape.for_graph(200_000)
    assert dense_adjacency_bytes(big) > DEFAULT_DENSE_BUDGET_BYTES
    r = TunableSpace("torch", big).validate(CandidateConfig())
    assert r is not None and "device-memory budget" in r
    # ... which is exactly the regime the two-level layout exists for
    assert TunableSpace("torch", big).validate(
        CandidateConfig(hbm_adjacency=1)) is None

    # hier budget: the kernel's row + summary in shared memory, against
    # the opt-in limit (an H100's without a card)
    assert TunableSpace("cuda", big).smem_limit_bytes == \
        HOPPER_SMEM_OPTIN_BYTES
    huge = WorkloadShape.for_graph(2_000_000)
    assert hier_refine_smem_bytes(huge, 8) > HOPPER_SMEM_OPTIN_BYTES
    r = TunableSpace("cuda", huge).validate(
        CandidateConfig(hbm_adjacency=1))
    assert r is not None and "shared memory" in r and "opt-in" in r


@pytest.mark.parametrize("v,c", [(128, 8), (4674, 8), (65536, 8),
                                 (65536, 1), (262144, 8), (200_000, 128)])
def test_hier_smem_is_the_kernel_wrappers(v, c):
    """The space's shared-memory figure is the wrapper's: the row in
    16-byte units plus ceil(ceil(W/C)/32) summary words, as the built
    layout has them."""
    from repro_torch.kernels.bitmap_refine import hier_smem_bytes
    w = (v + 31) // 32
    sw = -(-(-(-w // c)) // 32)
    assert hier_refine_smem_bytes(WorkloadShape.for_graph(v), c) == \
        hier_smem_bytes(w, sw) == 4 * (4 * -(-w // 4) + sw)


def test_hier_smem_matches_a_built_layout():
    from repro_torch.core.graph import build_hier_bitmap
    from repro_torch.kernels.bitmap_refine import hier_smem_bytes
    data = er_labeled_graph(3000, 6000, 3, seed=1)
    for c in (1, 8, 32):
        hb = build_hier_bitmap(data.n, data.indptr, data.indices, c)
        w = (data.n + 31) // 32
        assert hier_refine_smem_bytes(WorkloadShape.for_graph(data.n), c) \
            == hier_smem_bytes(w, hb.summary.shape[1])


def test_space_enumeration_partitions_cross_product():
    space = TunableSpace("cuda", WorkloadShape.for_graph(128),
                         smem_limit_bytes=HOPPER_SMEM_OPTIN_BYTES,
                         dense_budget_bytes=1 << 30)
    domains = {"block_f": [4, 8], "megastep_depth": [2, 6],
               "wave_size": [64], "n_slots": [8],
               "stack_capacity": [1024], "pattern_capacity": [4, 1024],
               "store_flush_min": [16], "hbm_adjacency": [0],
               "chunk_words": [8], "dma_depth": [2]}
    valid = space.candidates(overrides=domains)
    assert len(valid) + len(space.rejected) == 2 * 2 * 2
    # only pattern_capacity=4 (probe floor) is out: block_f=4 is legal
    assert len(valid) == 4
    assert all(c.pattern_capacity == 1024 for c in valid)
    assert all("probe window" in r for _, r in space.rejected)
    with pytest.raises(KeyError, match="warp_factor"):
        space.candidates(overrides={"warp_factor": [1]})


def test_smoke_domains_contain_default_point():
    from repro_torch.tuning.autotune import FULL_DOMAINS, SMOKE_DOMAINS
    d = CandidateConfig(wave_size=64)
    for k in ("block_f", "megastep_depth", "stack_capacity",
              "pattern_capacity", "store_flush_min"):
        assert getattr(d, k) in SMOKE_DOMAINS[k]
    # the reference's domains, block_f pinned at 8
    from repro.tuning.autotune import FULL_DOMAINS as REF_FULL
    from repro.tuning.autotune import SMOKE_DOMAINS as REF_SMOKE
    assert SMOKE_DOMAINS == REF_SMOKE and FULL_DOMAINS == REF_FULL
    assert SMOKE_DOMAINS["block_f"] == [8]


def _points():
    """Points around the budgets: valid and invalid on every rule that
    is not a budget."""
    rng = np.random.default_rng(0)
    pick = {"block_f": [1, 8, 16], "megastep_depth": [0, 1, 6],
            "wave_size": [48, 64, 512], "n_slots": [0, 8],
            "stack_capacity": [256, 1000, 1024],
            "pattern_capacity": [4, 8, 1024, 1000],
            "store_flush_min": [0, 16], "hbm_adjacency": [0, 1, 2],
            "chunk_words": [1, 3, 8, 256], "dma_depth": [0, 2]}
    return [{k: int(rng.choice(v)) for k, v in pick.items()}
            for _ in range(400)]


@pytest.mark.parametrize("v", [64, 128, 4674])
def test_space_verdicts_equal_the_reference(v):
    """On shapes where no budget rule binds, the port and the reference
    accept and reject the same points (the reference's backend jnp has
    no block_f rule either)."""
    port = TunableSpace("torch", WorkloadShape.for_graph(v))
    ref = RefSpace("jnp", RefShape.for_graph(v))
    n_valid = 0
    for p in _points():
        ok_port = port.validate(CandidateConfig(**p)) is None
        ok_ref = ref.validate(RefConfig(**p)) is None
        assert ok_port == ok_ref, p
        n_valid += ok_port
    assert 0 < n_valid < 400


def test_schema_keys_are_the_references_and_the_hash_is_not():
    from repro.tuning.space import KNOB_NAMES as REF_KNOBS
    from repro.tuning.space import schema_hash as ref_schema_hash
    from repro_torch.tuning.space import KNOB_NAMES
    assert KNOB_NAMES == REF_KNOBS
    assert CandidateConfig().as_params() == RefConfig().as_params()
    assert schema_hash() != ref_schema_hash() and len(schema_hash()) == 12


# ---------------------------------------------------------------- cache
def test_cache_roundtrip(tmp_path):
    p = tmp_path / "cache.json"
    params = CandidateConfig(megastep_depth=4, wave_size=128).as_params()
    rec = TuningCache(p).put("torch", "cpu", 100, params,
                             measured={"qps": 12.5})
    assert rec["name"] == "torch/cpu/v128"

    fresh = TuningCache(p)
    hit = fresh.lookup("torch", "cpu", 100)
    assert hit is not None and hit["params"] == params
    assert hit["measured"]["qps"] == 12.5
    assert quantize_vertices(100) == 128
    assert fresh.lookup("torch", "cpu", 4000) is None
    assert fresh.lookup("cuda", "cpu", 100) is None
    assert cache_key("cuda", "nvidia-h100-80gb-hbm3", 65536) == \
        "cuda/nvidia-h100-80gb-hbm3/v65536"


def test_cache_file_is_the_references_format(tmp_path):
    """Same file shape and bucketing as the reference; a record written
    by either package parses in the other, and each resolves only its
    own schema's records."""
    p = tmp_path / "cache.json"
    params = CandidateConfig(megastep_depth=4).as_params()
    TuningCache(p).put("torch", "cpu", 100, params)
    RefCache(p).put("jnp", "cpu", 100, params)      # same file, other key
    data = json.loads(p.read_text())
    assert set(data) == {"version", "schema_hash", "records"}
    assert set(data["records"]) == {"torch/cpu/v128", "jnp/cpu/v128"}
    assert TuningCache(p).lookup("torch", "cpu", 100)["params"] == params
    assert TuningCache(p).lookup("jnp", "cpu", 100) is None    # stale
    assert RefCache(p).lookup("torch", "cpu", 100) is None
    assert RefCache(p).lookup("jnp", "cpu", 100)["params"] == params
    for n in (1, 33, 100, 4674, 65536, 65537):
        assert quantize_vertices(n) == __import__(
            "repro.tuning.cache", fromlist=["x"]).quantize_vertices(n)


def test_cache_schema_hash_invalidates_stale_records(tmp_path):
    p = tmp_path / "cache.json"
    TuningCache(p).put("torch", "cpu", 128, CandidateConfig().as_params())
    data = json.loads(p.read_text())
    data["records"]["torch/cpu/v128"]["schema_hash"] = "deadbeef0000"
    p.write_text(json.dumps(data))
    assert TuningCache(p).lookup("torch", "cpu", 128) is None
    assert len(schema_hash()) == 12


def test_cache_resets_on_version_or_shape_mismatch(tmp_path):
    p = tmp_path / "cache.json"
    p.write_text(json.dumps({"version": 99, "records": {"x": {}}}))
    assert TuningCache(p).records() == {}
    p.write_text("not json at all")
    assert TuningCache(p).records() == {}
    p.write_text(json.dumps({"version": 1, "records": []}))
    assert TuningCache(p).records() == {}


def test_cache_path_and_device_kind_are_the_ports(monkeypatch, tmp_path):
    """The reference's variables never move the port; the default file
    is the port's own; the host's kind is "cpu"; the default device is
    the card, as every entry point's, so without one it raises."""
    monkeypatch.delenv("REPRO_TORCH_TUNING_CACHE")
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "ref.json"))
    assert tcache.default_cache_path().name == "TUNING_CACHE_TORCH.json"
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "t.json"))
    assert tcache.default_cache_path() == tmp_path / "t.json"
    assert device_kind(CPU) == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            device_kind()
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            kconfig.device_backend()


def test_device_backend_names_the_kernels_a_device_takes():
    assert kconfig.device_backend(CPU) == "torch"
    assert kconfig.device_backend(torch.device("cuda")) == "cuda"
    with kconfig.backend_scope("torch"):
        assert kconfig.device_backend(torch.device("cuda")) == "torch"
    with kconfig.backend_scope("cuda"):
        assert kconfig.device_backend(CPU) == "cuda"


# ----------------------------------------------------------- resolution
def _seed_cache(monkeypatch, tmp_path, n_vertices=512, backend="torch",
                **param_overrides):
    """Point the port's default cache at a tmp file holding one record
    for (backend, the CPU, n_vertices)."""
    p = tmp_path / "TUNING_CACHE_TORCH.json"
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(p))
    params = CandidateConfig(**param_overrides).as_params()
    TuningCache(p).put(backend, "cpu", n_vertices, params)
    return params


def test_resolution_cache_fills_only_unset_knobs(monkeypatch, tmp_path):
    _seed_cache(monkeypatch, tmp_path, megastep_depth=4, wave_size=128,
                block_f=16)
    knobs, rec = resolve_engine_options(MatchOptions(n_slots=2),
                                        backend="torch", n_vertices=512,
                                        device=CPU)
    assert set(rec) == DESCRIPTOR_KEYS
    assert rec["source"] == "tuning-cache"
    assert rec["record"] == rec["key"] == cache_key("torch", "cpu", 512)
    assert rec["backend"] == "torch" and rec["v_bucket"] == 512
    assert knobs["megastep_depth"] == 4
    assert knobs["wave_size"] == 128
    assert knobs["block_f"] == 16
    assert knobs["n_slots"] == 2                   # explicit, not filled
    assert sorted(rec["filled_from_cache"]) == sorted(
        set(ENGINE_TUNABLE_DEFAULTS) - {"n_slots"} | {"block_f"})
    assert rec["params"] == knobs


def test_resolution_explicit_options_beat_cache(monkeypatch, tmp_path):
    _seed_cache(monkeypatch, tmp_path, megastep_depth=4, wave_size=128)
    opts = MatchOptions(megastep_depth=12, wave_size=256)
    knobs, rec = resolve_engine_options(opts, backend="torch",
                                        n_vertices=512, device=CPU)
    assert rec["source"] == "tuning-cache"
    assert knobs["megastep_depth"] == 12
    assert knobs["wave_size"] == 256
    assert "megastep_depth" not in rec["filled_from_cache"]
    assert "wave_size" not in rec["filled_from_cache"]


def test_resolution_scope_override_beats_cache(monkeypatch, tmp_path):
    _seed_cache(monkeypatch, tmp_path, block_f=16, hbm_adjacency=1,
                chunk_words=4, dma_depth=4)
    with kconfig.kernel_param_scope(block_f=24, hbm_adjacency=0,
                                    chunk_words=2):
        knobs, _ = resolve_engine_options(MatchOptions(), backend="torch",
                                          n_vertices=512, device=CPU)
        assert not kconfig.use_hbm_adjacency("torch", 512, CPU)
        assert kconfig.kernel_chunk_words("torch", 512, CPU) == 2
        assert kconfig.kernel_dma_depth("torch", 512, CPU) == 4  # record
    assert knobs["block_f"] == 24
    assert kconfig.kernel_override("block_f") is None
    # the record, once the scope is gone
    assert kconfig.use_hbm_adjacency("torch", 512, CPU)
    assert kconfig.kernel_chunk_words("torch", 512, CPU) == 4
    assert kconfig.kernel_block_f("torch", 512, CPU) == 16
    # the built-ins on a miss (other bucket, other backend)
    assert not kconfig.use_hbm_adjacency("torch", 4000, CPU)
    assert kconfig.kernel_chunk_words("cuda", 512, CPU) == \
        kconfig.DEFAULT_CHUNK_WORDS
    assert kconfig.use_hbm_adjacency("torch", 16384, CPU)


def test_resolution_builtin_on_miss_or_disable(monkeypatch, tmp_path):
    _seed_cache(monkeypatch, tmp_path, megastep_depth=4, n_vertices=512)
    knobs, rec = resolve_engine_options(MatchOptions(), backend="torch",
                                        n_vertices=33, device=CPU)
    assert rec["source"] == "builtin" and rec["record"] is None
    assert knobs["megastep_depth"] == \
        ENGINE_TUNABLE_DEFAULTS["megastep_depth"]
    assert knobs["block_f"] == kconfig.DEFAULT_BLOCK_F
    # the reference's kill switch does not move the port ...
    monkeypatch.setenv("REPRO_TUNING_DISABLE", "1")
    _, rec = resolve_engine_options(MatchOptions(), backend="torch",
                                    n_vertices=512, device=CPU)
    assert rec["source"] == "tuning-cache"
    # ... the port's does
    monkeypatch.setenv("REPRO_TORCH_TUNING_DISABLE", "1")
    knobs, rec = resolve_engine_options(MatchOptions(), backend="torch",
                                        n_vertices=512, device=CPU)
    assert rec["source"] == "builtin" and set(rec) == DESCRIPTOR_KEYS
    assert knobs == {**{k: int(v) for k, v
                        in ENGINE_TUNABLE_DEFAULTS.items()},
                     "block_f": kconfig.DEFAULT_BLOCK_F}
    assert kconfig.kernel_dma_depth("torch", 512, CPU) == \
        kconfig.DEFAULT_DMA_DEPTH


@pytest.mark.parametrize("explicit", [
    {}, {"wave_size": 256}, {"n_slots": 4, "megastep_depth": 12},
    {"stack_capacity": 2048, "pattern_capacity": 64,
     "store_flush_min": 1}])
def test_resolution_equals_the_reference(monkeypatch, tmp_path, explicit):
    """The same record params and explicit knobs give the same knobs,
    the same ``filled_from_cache`` and the same descriptor keys in both
    packages (each under its own backend name and cache file)."""
    params = CandidateConfig(megastep_depth=4, wave_size=128, n_slots=2,
                             stack_capacity=512, pattern_capacity=256,
                             store_flush_min=8, block_f=16).as_params()
    port_p, ref_p = tmp_path / "port.json", tmp_path / "ref.json"
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(port_p))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(ref_p))
    monkeypatch.delenv("REPRO_TUNING_DISABLE", raising=False)
    TuningCache(port_p).put("torch", "cpu", 300, params)
    RefCache(ref_p).put("jnp", ref_device_kind(), 300, params)
    knobs, rec = resolve_engine_options(MatchOptions(**explicit),
                                        backend="torch", n_vertices=300,
                                        device=CPU)
    rknobs, rrec = ref_resolve(RefOptions(**explicit), backend="jnp",
                               n_vertices=300)
    assert knobs == rknobs
    assert rec["filled_from_cache"] == rrec["filled_from_cache"]
    assert set(rec) == set(rrec) == DESCRIPTOR_KEYS
    assert rec["source"] == rrec["source"] == "tuning-cache"
    assert rec["v_bucket"] == rrec["v_bucket"] == 512
    assert rec["params"] == rrec["params"]


def test_scheduler_consumes_and_surfaces_tuned_record(monkeypatch,
                                                      tmp_path):
    """WaveScheduler construction keys its lookup by its own device's
    backend ("torch" on the CPU), resolves through the cache and shows
    the consumed record in scheduler_stats()."""
    data = er_labeled_graph(40, 120, 3, seed=6)          # bucket v64
    _seed_cache(monkeypatch, tmp_path, n_vertices=data.n,
                megastep_depth=2, wave_size=32, n_slots=2,
                stack_capacity=256, pattern_capacity=64,
                store_flush_min=8)
    sched = WaveScheduler(data, options=MatchOptions(limit=None),
                          device="cpu")
    assert sched.megastep_depth == 2
    assert sched.wave_size == 32 and sched.n_slots == 2
    assert sched.pattern_capacity == 64
    stats = sched.scheduler_stats()
    assert stats["tuning"]["source"] == "tuning-cache"
    assert stats["tuning"]["backend"] == "torch"
    assert stats["tuning"]["record"] == cache_key("torch", "cpu", data.n)
    q = random_walk_query(data, 4, seed=1)
    qid = sched.submit(q)
    finished = sched.run()
    assert embset(finished[qid].embeddings) == \
        embset(oracle(q, data, limit=None).embeddings)
    # a record under the other backend's key is not this device's
    with kconfig.backend_scope("cuda"):
        other = WaveScheduler(data, options=MatchOptions(limit=None),
                              device="cpu")
    assert other.tuning_record["source"] == "builtin"
    assert other.tuning_record["key"] == cache_key("cuda", "cpu", data.n)


def test_scheduler_layout_knobs_resolve_through_the_record(monkeypatch,
                                                           tmp_path):
    """hbm_adjacency / chunk_words in a record switch a small graph to
    the two-level layout; a scope override or an options pin wins over
    the record; the oracle's set either way."""
    data = er_labeled_graph(300, 900, 3, seed=4)          # bucket v512
    _seed_cache(monkeypatch, tmp_path, n_vertices=data.n, wave_size=64,
                stack_capacity=256, hbm_adjacency=1, chunk_words=2)
    q = random_walk_query(data, 4, seed=2)
    want = embset(oracle(q, data, limit=None).embeddings)

    def run(**knobs):
        sched = WaveScheduler(data, options=MatchOptions(limit=None,
                                                         **knobs),
                              device="cpu")
        qid = sched.submit(q)
        assert embset(sched.run()[qid].embeddings) == want
        return sched

    s = run()
    assert s.adjacency_variant == "hier-hbm" and s.chunk_words == 2
    with kconfig.kernel_param_scope(hbm_adjacency=0):
        assert run().adjacency_variant == "dense-vmem"
    with kconfig.kernel_param_scope(chunk_words=8):
        assert run().chunk_words == 8
    assert run(hier_adjacency=False).adjacency_variant == "dense-vmem"
    assert run(chunk_words=4).chunk_words == 4
    monkeypatch.setenv("REPRO_TORCH_TUNING_DISABLE", "1")
    assert run().adjacency_variant == "dense-vmem"


# ------------------------------------------------- weird-config oracle
@pytest.mark.parametrize("case", ["uniform", "trap", "corridor"])
def test_weird_config_matches_oracle(case, monkeypatch):
    """An awkward tuned point — odd block height in scope, shallow
    megastep, K=3, a 16-slot pattern store — moves time only, never
    results."""
    monkeypatch.setenv("REPRO_TORCH_TUNING_DISABLE", "1")
    if case == "uniform":
        data = er_labeled_graph(30, 80, 3, seed=2)
        query = random_walk_query(data, 4, seed=3)
    elif case == "trap":
        query, data = trap_graph(n_b=20, n_c=20, n_good=2, tail_len=2,
                                 seed=0)
    else:
        query, data = corridor_graph(n_bait=12, n_spines=2)
    opts = MatchOptions(limit=None, kpr=3, megastep_depth=3,
                        pattern_capacity=16, stack_capacity=256,
                        wave_size=32, n_slots=2, store_flush_min=1)
    with kconfig.backend_scope("torch"), \
            kconfig.kernel_param_scope(block_f=5):
        sched = WaveScheduler(data, options=opts, device="cpu")
        assert sched.tuning_record["params"]["block_f"] == 5
        qid = sched.submit(query)
        finished = sched.run()
    want = oracle(query, data, limit=None)
    assert embset(finished[qid].embeddings) == embset(want.embeddings)


# ------------------------------------------------ measure and autotune
def test_smoke_workload_digest_equals_the_reference():
    """Two candidate points give one digest, and it is the reference's
    for the same workload (the same generators, the same formula)."""
    from repro.tuning.measure import run_smoke_workload as ref_run
    from repro_torch.tuning.measure import run_smoke_workload
    a = CandidateConfig(wave_size=64, megastep_depth=4).as_params()
    b = CandidateConfig(wave_size=64, megastep_depth=8,
                        pattern_capacity=512).as_params()
    ra = run_smoke_workload(a, warmup=0, trials=1, device="cpu")
    rb = run_smoke_workload(b, warmup=0, trials=1, device="cpu")
    assert ra["digest"] == rb["digest"]
    assert ra["n_embeddings"] == rb["n_embeddings"] > 0
    ref = ref_run(RefConfig(**a).as_params(), backend="jnp", warmup=0,
                  trials=1)
    assert ref["digest"] == ra["digest"]
    assert ref["n_embeddings"] == ra["n_embeddings"]


def test_embeddings_digest_formula_is_the_references():
    from repro.tuning.measure import _embeddings_digest as ref_digest
    from repro_torch.tuning.measure import _embeddings_digest
    rng = np.random.default_rng(3)
    fin = {q: type("R", (), {"embeddings": [
        rng.integers(0, 500, size=5).astype(np.int32)
        for _ in range(int(rng.integers(0, 6)))]})()
           for q in (3, 0, 7)}
    assert _embeddings_digest(fin) == ref_digest(fin)


def test_timed_trials_runs_warmup_then_trials():
    from repro_torch.tuning.measure import timed_trials
    calls = []
    t = timed_trials(lambda: calls.append(1), warmup=2, trials=3,
                     device=CPU)
    assert len(calls) == 5 and t >= 0.0


def test_refine_microbench_on_the_cpu():
    from repro_torch.tuning.measure import refine_microbench
    assert refine_microbench("torch", 8, n_vertices=64, trials=1,
                             device="cpu") > 0.0
    with pytest.raises(RuntimeError, match="forced"):
        refine_microbench("cuda", 8, n_vertices=64, trials=1,
                          device="cpu")


def test_autotune_cli_writes_a_record_the_scheduler_consumes(
        monkeypatch, tmp_path, capsys):
    """``python -m repro_torch.tuning.autotune --smoke --device cpu``:
    the sweep's one digest, a ``torch/cpu/v128`` record, and a knob-free
    scheduler on the smoke graph resolving it with the same digest."""
    from repro_torch.tuning.autotune import main
    from repro_torch.tuning.measure import (SMOKE_SHAPE, _embeddings_digest,
                                            smoke_workload)
    path = tmp_path / "tuned.json"
    assert main(["--smoke", "--device", "cpu", "--trials", "1",
                 "--cache", str(path)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["backend"] == "torch" and report["device_kind"] == "cpu"
    assert report["record"] == "torch/cpu/v128"
    assert report["n_candidates"] == 6 and report["n_rejected"] == 0
    assert report["refine_microbench_ms"] is None
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(path))
    s = SMOKE_SHAPE
    data, queries = smoke_workload()
    sched = WaveScheduler(data, options=MatchOptions(
        limit=s["limit"], time_budget_s=s["time_budget_s"], kpr=s["kpr"]),
        device="cpu")
    for q in queries:
        sched.submit(q)
    assert _embeddings_digest(sched.run()) == report["digest"]
    tuning = sched.scheduler_stats()["tuning"]
    assert tuning["source"] == "tuning-cache"
    assert tuning["record"] == "torch/cpu/v128"
    assert {k: tuning["params"][k] for k in ENGINE_TUNABLE_DEFAULTS} == \
        {k: report["best"]["params"][k] for k in ENGINE_TUNABLE_DEFAULTS}
    # --dry-run writes nothing
    other = tmp_path / "dry.json"
    assert main(["--smoke", "--device", "cpu", "--trials", "1", "--cache",
                 str(other), "--dry-run"]) == 0
    assert not other.exists()
