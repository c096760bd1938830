"""The port's kernel-op layer (``repro_torch.kernels.ops``) against the
JAX package's (``repro.kernels.ops``), on the CPU.

The same numpy inputs, made from a seed, go through the reference op —
its Pallas kernel run as ``tests/test_kernels.py`` runs it
(``backend="pallas_interpret"``) — and through the port's op, which for
a CPU tensor runs the plain version. Tolerances, as the reference's own
tests state them:

  * ``bitmap_spmm``: rtol 1e-5 / atol 1e-5 in f32, 2e-2 in bf16 (the
    sum runs in another order than the reference's blocked one);
  * ``flash_attention``: 2e-4 in f32, 2e-2 in bf16;
  * the refine ops: equal by bit pattern (the reference returns uint32
    words, the port int32).

The CUDA kernels behind these ops are held against the same plain
versions on the card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.graph import build_hier_bitmap, pack_bitmap
from repro.data.graph_gen import human_like_graph
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.kernels import (bitmap_refine, bitmap_spmm, config,
                                 flash_attention, ops)
from repro_torch.kernels import ref
from repro_torch.kernels.ref import bitmap_spmm_ref

torch.set_num_threads(1)

BF16 = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _t(a, dtype=None):
    """numpy -> CPU tensor (uint32 words as their int32 bit patterns)."""
    t = torch.from_numpy(convert.as_int32(np.array(a)))
    return t if dtype is None else t.to(dtype)


def _f32(a):
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------- spmm
@pytest.mark.parametrize("n,m,d,dtype", [
    (40, 64, 16, jnp.float32), (100, 96, 48, jnp.float32),
    (256, 256, 128, jnp.float32), (33, 32, 8, jnp.bfloat16),
])
def test_bitmap_spmm_op_matches_reference(n, m, d, dtype):
    rng = np.random.default_rng(n + m + d)
    words = pack_bitmap(rng.random((n, m)) < 0.15)
    x = rng.standard_normal((m, d)).astype(np.float32)
    xj = jnp.asarray(x, dtype=dtype)
    want = jops.bitmap_spmm_op(jnp.asarray(words), xj,
                               backend="pallas_interpret", block_i=32,
                               block_j=32)
    got = ops.bitmap_spmm_op(_t(words), _t(_f32(xj), BF16[dtype]))
    assert got.dtype == BF16[dtype] and got.shape == (n, d)
    np.testing.assert_allclose(
        got.float().numpy(), _f32(want),
        rtol=2e-2 if dtype == jnp.bfloat16 else 1e-5, atol=1e-5)


def test_bitmap_spmm_op_bit31_words():
    """Words with bit 31 set are negative int32 in the port: column
    32 w + 31 must still be read as set."""
    rng = np.random.default_rng(31)
    dense = rng.random((24, 96)) < 0.3
    dense[:, 31::32] = True
    dense[5] = False
    dense[7, 95] = True                  # a row whose only bit is bit 31
    words = pack_bitmap(dense)
    assert (words >> np.uint32(31)).any()
    x = rng.standard_normal((96, 12)).astype(np.float32)
    want = jops.bitmap_spmm_op(jnp.asarray(words), jnp.asarray(x),
                               backend="pallas_interpret", block_i=32,
                               block_j=32)
    got = ops.bitmap_spmm_op(_t(words), _t(x))
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense.astype(np.float32) @ x,
                               rtol=1e-5, atol=1e-5)


def test_bitmap_spmm_op_human_like_adjacency():
    """The matcher's own packed adjacency (4674 vertices, W = 147) times
    D = 8 features."""
    g = human_like_graph(seed=0)
    words = g.adj_bitmap
    rng = np.random.default_rng(8)
    x = rng.standard_normal((32 * words.shape[1], 8)).astype(np.float32)
    want = jops.bitmap_spmm_op(jnp.asarray(words), jnp.asarray(x),
                               backend="pallas_interpret", block_i=1024,
                               block_j=1024)
    got = ops.bitmap_spmm_op(_t(words), _t(x))
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-5,
                               atol=1e-5)


def test_bitmap_spmm_ref_row_blocks_change_nothing(monkeypatch):
    """The plain version unpacks a block of rows at a time; the block
    height changes no bit."""
    rng = np.random.default_rng(5)
    words = _t(pack_bitmap(rng.random((70, 64)) < 0.2))
    x = torch.from_numpy(rng.standard_normal((64, 9)).astype(np.float32))
    whole = bitmap_spmm_ref(words, x)
    for block in (1, 16, 69):
        monkeypatch.setattr(ref, "SPMM_ROW_BLOCK", block)
        assert torch.equal(bitmap_spmm_ref(words, x), whole)


# ---------------------------------------------------------------- flash
def _qkv(rng, b, h, hkv, s, skv, d):
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, s, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def _flash_pair(arrays, dtype, causal, block_q, block_k, ref_backend):
    js = [jnp.asarray(a, dtype) for a in arrays]
    want = jops.flash_attention_op(*js, causal=causal, backend=ref_backend,
                                   block_q=block_q, block_k=block_k)
    got = ops.flash_attention_op(*(_t(_f32(a), BF16[dtype]) for a in js),
                                 causal=causal, block_q=block_q,
                                 block_k=block_k)
    assert got.dtype == BF16[dtype]
    return got.float().numpy(), _f32(want)


@pytest.mark.parametrize("b,h,hkv,s,d,causal", [
    (1, 2, 2, 128, 32, True),
    (2, 4, 2, 128, 64, True),    # GQA
    (1, 2, 1, 256, 64, False),
    (1, 8, 2, 128, 128, True),
])
def test_flash_attention_op_matches_reference(b, h, hkv, s, d, causal):
    rng = np.random.default_rng(b * 100 + h)
    got, want = _flash_pair(_qkv(rng, b, h, hkv, s, s, d), jnp.float32,
                            causal, 64, 64, "pallas_interpret")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_attention_op_dtypes(dtype):
    rng = np.random.default_rng(3)
    got, want = _flash_pair(_qkv(rng, 1, 2, 2, 128, 128, 64), dtype, True,
                            64, 64, "pallas_interpret")
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_flash_attention_op_long_kv_decode_shape():
    rng = np.random.default_rng(4)
    got, want = _flash_pair(_qkv(rng, 2, 4, 4, 128, 512, 64), jnp.float32,
                            False, 128, 128, "pallas_interpret")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_flash_attention_op_causal_short_query_follows_pallas():
    """Causal with S < Skv: key j is visible to query i iff j <= i, from
    position 0 — the reference's Pallas kernel's mask."""
    rng = np.random.default_rng(6)
    got, want = _flash_pair(_qkv(rng, 1, 4, 2, 64, 256, 32), jnp.float32,
                            True, 32, 64, "pallas_interpret")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_flash_attention_causal_mask_differs_from_jnp_oracle():
    """The reference's jnp oracle aligns the causal mask at the end
    (``tril(k=Skv - S)``), its Pallas kernel at position 0. They agree
    when S == Skv and differ when S < Skv; the port follows the Pallas
    kernel."""
    rng = np.random.default_rng(7)
    square = _qkv(rng, 1, 2, 2, 64, 64, 32)
    got, want = _flash_pair(square, jnp.float32, True, 64, 64, "jnp")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    short = _qkv(rng, 1, 2, 2, 64, 128, 32)
    got, oracle = _flash_pair(short, jnp.float32, True, 64, 64, "jnp")
    assert np.abs(got - oracle).max() > 0.1
    # the oracle's end-aligned mask, written out: query i sees j <= i + 64
    q, k, v = (torch.from_numpy(a).double() for a in short)
    logits = (q @ k.transpose(-1, -2)) * 32 ** -0.5
    visible = torch.ones(64, 128, dtype=torch.bool).tril(64)
    probs = torch.softmax(logits.masked_fill(~visible, float("-inf")), -1)
    np.testing.assert_allclose((probs @ v).numpy(), oracle, rtol=2e-4,
                               atol=2e-4)


def test_flash_attention_rejects_non_dividing_blocks():
    q, k, v = (_t(a) for a in _qkv(np.random.default_rng(0), 1, 2, 2, 96,
                                   96, 16))
    with pytest.raises(ValueError, match="divide"):
        ops.flash_attention_op(q, k, v, block_q=64)
    with pytest.raises(ValueError, match="divide"):
        ops.flash_attention_op(q, k, v, block_k=64)
    with pytest.raises(ValueError, match="Hkv must divide H"):
        ops.flash_attention_op(q, k[:, :1].repeat(1, 3, 1, 1),
                               v[:, :1].repeat(1, 3, 1, 1))
    assert ops.flash_attention_op(q, k, v, block_q=32,
                                  block_k=48).shape == q.shape


# ---------------------------------------------------------------- refine
def _graph(v, seed):
    rng = np.random.default_rng(seed)
    dense = rng.random((v, v)) < 0.2
    dense |= dense.T
    return rng, dense


def _bits(a):
    return convert.as_int32(np.asarray(a))


@pytest.mark.parametrize("v,f,np_,seed", [
    (33, 4, 5, 0), (128, 16, 8, 1), (300, 32, 12, 2)])
def test_refine_bitmap_op_matches_reference(v, f, np_, seed):
    rng, dense = _graph(v, seed)
    adj = pack_bitmap(dense)
    cand = pack_bitmap(rng.random((1, v)) < 0.5)[0]
    frontier = rng.integers(-1, v, size=(f, np_)).astype(np.int32)
    active = (rng.random(np_) < 0.6).astype(np.int32)
    want = jops.refine_bitmap_op(*map(jnp.asarray, (adj, cand, frontier,
                                                    active)),
                                 backend="pallas_interpret")
    got = ops.refine_bitmap_op(*map(_t, (adj, cand, frontier, active)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _bits(want))


@pytest.mark.parametrize("v,f,np_,seed", [
    (48, 3, 6, 0), (200, 21, 9, 2), (520, 40, 12, 3)])
def test_refine_bitmap_rows_op_matches_reference(v, f, np_, seed):
    rng, dense = _graph(v, seed)
    adj = pack_bitmap(dense)
    cand = pack_bitmap(rng.random((f, v)) < 0.5)
    frontier = rng.integers(-1, v, size=(f, np_)).astype(np.int32)
    active = (rng.random((f, np_)) < 0.6).astype(np.int32)
    want = jops.refine_bitmap_rows_op(
        *map(jnp.asarray, (adj, cand, frontier, active)),
        backend="pallas_interpret")
    got = ops.refine_bitmap_rows_op(*map(_t, (adj, cand, frontier, active)))
    np.testing.assert_array_equal(got.numpy(), _bits(want))


@pytest.mark.parametrize("v,f,np_,cw,seed", [
    (48, 6, 5, 1, 0), (300, 16, 8, 8, 1), (520, 24, 9, 4, 2)])
def test_refine_bitmap_rows_hier_op_matches_reference(v, f, np_, cw, seed):
    rng, dense = _graph(v, seed)
    indptr = np.concatenate(([0], np.cumsum(dense.sum(axis=1))))
    hb = build_hier_bitmap(v, indptr, np.nonzero(dense)[1], chunk_words=cw)
    lanes = [hb.summary, hb.chunk_ptr, hb.chunk_id, hb.chunk_data]
    cand = pack_bitmap(rng.random((f, v)) < 0.5)
    frontier = rng.integers(-1, v, size=(f, np_)).astype(np.int32)
    active = (rng.random((f, np_)) < 0.6).astype(np.int32)
    want = jops.refine_bitmap_rows_hier_op(
        *map(jnp.asarray, lanes), hb.kmax,
        *map(jnp.asarray, (cand, frontier, active)),
        backend="pallas_interpret")
    got = ops.refine_bitmap_rows_hier_op(
        *map(_t, lanes), hb.kmax, *map(_t, (cand, frontier, active)))
    np.testing.assert_array_equal(got.numpy(), _bits(want))
    dense_got = ops.refine_bitmap_rows_op(
        _t(pack_bitmap(dense)), *map(_t, (cand, frontier, active)))
    assert torch.equal(got, dense_got)


# ---------------------------------------------------------------- routing
def _spmm_args():
    rng = np.random.default_rng(1)
    return (_t(pack_bitmap(rng.random((8, 32)) < 0.3)),
            torch.from_numpy(rng.standard_normal((32, 4)).astype(np.float32)))


def _flash_args():
    return [_t(a) for a in _qkv(np.random.default_rng(2), 1, 2, 1, 16, 16,
                                8)]


def _refine_args():
    rng, dense = _graph(40, 3)
    return [_t(pack_bitmap(dense)), _t(pack_bitmap(rng.random((3, 40)) < .5)),
            _t(rng.integers(-1, 40, (3, 4)).astype(np.int32)),
            _t(np.ones((3, 4), np.int32))]


CALLS = {
    "spmm": lambda backend: ops.bitmap_spmm_op(*_spmm_args(),
                                               backend=backend),
    "flash": lambda backend: ops.flash_attention_op(*_flash_args(),
                                                    backend=backend),
    "refine_rows": lambda backend: ops.refine_bitmap_rows_op(
        *_refine_args(), backend=backend),
}


@pytest.mark.parametrize("op", sorted(CALLS))
def test_forcing_cuda_on_cpu_tensors_raises(op):
    with pytest.raises(RuntimeError, match="forced"):
        CALLS[op]("cuda")
    assert config.get_backend() is None


@pytest.mark.parametrize("op", sorted(CALLS))
def test_unknown_backend_raises(op):
    for name in ("pallas", "jnp", "triton"):
        with pytest.raises(ValueError, match="unknown kernel backend"):
            CALLS[op](name)


@pytest.mark.parametrize("op", sorted(CALLS))
def test_cpu_tensors_take_the_plain_path(op, monkeypatch):
    """A CPU tensor runs the plain version, with or without
    ``backend="torch"``: no build, no launch."""
    def no_library(*_):
        pytest.fail("a CUDA library was requested for CPU tensors")
    for mod in (bitmap_refine, bitmap_spmm, flash_attention):
        monkeypatch.setattr(mod, "_library", no_library)
    counts = (bitmap_refine.LAUNCHES, bitmap_spmm.SPMM_LAUNCHES,
              flash_attention.FLASH_LAUNCHES)
    assert torch.equal(CALLS[op](None), CALLS[op]("torch"))
    with config.backend_scope("torch"):
        assert torch.equal(CALLS[op](None), CALLS[op]("torch"))
    assert (bitmap_refine.LAUNCHES, bitmap_spmm.SPMM_LAUNCHES,
            flash_attention.FLASH_LAUNCHES) == counts


@pytest.mark.parametrize("op", sorted(CALLS))
def test_per_call_backend_leaves_process_state(op, monkeypatch):
    """``backend=`` reaches the wrapper for that call only: while the op
    runs, the process-wide backend (seen by every other thread's calls)
    stays as it was."""
    seen = []
    for mod, name in ((bitmap_refine, "refine_bitmap_rows_ref"),
                      (bitmap_spmm, "bitmap_spmm_ref"),
                      (flash_attention, "flash_attention_ref")):
        plain = getattr(mod, name)

        def spy(*a, plain=plain, **kw):
            seen.append(config.get_backend())
            return plain(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    CALLS[op]("torch")
    assert seen == [None]


def test_spmm_rejects_a_width_mismatch():
    words, x = _spmm_args()
    with pytest.raises(ValueError, match="32 W"):
        ops.bitmap_spmm_op(words, x[:31])
