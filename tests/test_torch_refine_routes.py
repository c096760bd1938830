"""The two refine kernels' decompositions, emulated on the CPU.

``ref.refine_dense_schedule`` states how the dense CUDA kernel splits a
row of cand / out (a scalar head up to the first 16-byte boundary, 16-byte
units, a scalar tail; tiles of 160 words on the 16-byte grid; positions
gathered 8 at a time) and ``ref.refine_hier_schedule`` the hier kernel's
flat walk of a row (every walked position's stored chunks, in 4-word
units, one index space). Here every output word and every stored chunk
word must be covered exactly once, for rows at each of the four word
alignments mod 16 bytes, row widths 1 to 8192 words, chunk widths 1 to
128 and 0 to 64 active positions; and the refines built on those
schedules (``ref.refine_rows_by_schedule``,
``ref.refine_rows_hier_by_schedule``) must equal the plain versions and
the JAX package's Pallas kernels in interpret mode, bit for bit (every
lane is a packed bitmap word: no tolerance). Inputs come from numpy with
a seed. The kernels themselves run on the card in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import graph as jgraph
from repro.kernels.ops import (refine_bitmap_rows_hier_op,
                               refine_bitmap_rows_op)
from repro_torch import convert
from repro_torch.core.graph import build_hier_bitmap
from repro_torch.kernels.ref import (DENSE_GROUP, DENSE_TILE_WORDS,
                                     refine_bitmap_rows_hier_ref,
                                     refine_bitmap_rows_ref,
                                     refine_dense_schedule,
                                     refine_hier_schedule,
                                     refine_rows_by_schedule,
                                     refine_rows_hier_by_schedule)

torch.set_num_threads(1)

WIDTHS = [1, 3, 4, 147, 2048, 8192]
N_ACTIVE = [0, 1, 7, 8, 9, 64]
CHUNK_WIDTHS = [1, 2, 4, 8, 16, 32, 64, 128]


def _i32(a):
    return torch.from_numpy(convert.as_int32(np.array(a)))


def _graph(v, seed, density=0.2):
    rng = np.random.default_rng(seed)
    dense = rng.random((v, v)) < density
    dense |= dense.T
    indptr = np.concatenate(([0], np.cumsum(dense.sum(axis=1))))
    return dense, indptr, np.nonzero(dense)[1]


def _rows(v, f, np_, n_active, seed):
    """cand, frontier, active with exactly ``n_active`` active positions
    a row (some -1, some past V - 1 on odd rows)."""
    rng = np.random.default_rng(seed)
    cand = jgraph.pack_bitmap(rng.random((f, v)) < 0.5)
    frontier = rng.integers(0, v, (f, np_)).astype(np.int32)
    active = np.zeros((f, np_), np.int32)
    for i in range(f):
        active[i, rng.choice(np_, n_active, replace=False)] = 1
    frontier[::3, 0] = -1
    frontier[1::2, 1] = v + 2
    return cand, frontier, active


# ------------------------------------------------------------ dense kernel
@pytest.mark.parametrize("base", range(4))
@pytest.mark.parametrize("n_words", WIDTHS)
def test_dense_schedule_covers_every_word_once(n_words, base):
    """Head, 16-byte body and tail cover the row once; body units and
    tiles sit on the 16-byte grid; the tiles' gathers cover it once."""
    for row in range(4):
        sch = refine_dense_schedule(n_words, row, base=base)
        start = base + row * n_words
        words = sch["head"] + sch["tail"] + [
            w + k for w in sch["body"] for k in range(4)]
        assert sorted(words) == list(range(n_words))
        assert sch["lead"] == start % 4
        assert len(sch["head"]) == min(-start % 4, n_words)
        assert all((start + w) % 4 == 0 for w in sch["body"])
        assert all((start + t) % 4 == 0 for t in sch["tiles"])
        assert len(sch["tiles"]) == -(-(n_words + sch["lead"])
                                      // DENSE_TILE_WORDS)
        gathered = torch.cat(sch["gather"])
        assert sorted(gathered[gathered >= 0].tolist()) == list(
            range(n_words))


def test_dense_schedule_main_path_row_is_one_tile():
    """A 147-word row at any alignment takes one tile: all its gathers
    and cand loads in flight together."""
    for row in range(4):
        assert len(refine_dense_schedule(147, row)["tiles"]) == 1


@pytest.mark.parametrize("n_active", N_ACTIVE)
def test_dense_schedule_gathers_every_position_once(n_active):
    groups = refine_dense_schedule(147, 0, n_active)["groups"]
    assert [p for g in groups for p in g] == list(range(n_active))
    assert all(0 < len(g) <= DENSE_GROUP for g in groups)
    assert len(groups) == -(-n_active // DENSE_GROUP)


@pytest.mark.parametrize("n_active", N_ACTIVE)
@pytest.mark.parametrize("v,f,seed", [(48, 4, 0), (200, 6, 1),
                                      (520, 5, 2)])
def test_dense_by_schedule_matches_plain_and_pallas(v, f, seed, n_active):
    dense, _, _ = _graph(v, seed)
    adj = jgraph.pack_bitmap(dense)
    cand, frontier, active = _rows(v, f, 64, n_active, seed)
    want = refine_bitmap_rows_ref(_i32(adj), _i32(cand), _i32(frontier),
                                  _i32(active))
    pallas = np.asarray(refine_bitmap_rows_op(
        jnp.asarray(adj), jnp.asarray(cand), jnp.asarray(frontier),
        jnp.asarray(active), backend="pallas_interpret")).view(np.int32)
    np.testing.assert_array_equal(want.numpy(), pallas)
    for base in range(4):
        got = refine_rows_by_schedule(_i32(adj), _i32(cand), _i32(frontier),
                                      _i32(active), base=base)
        assert torch.equal(got, want), base


# ------------------------------------------------------------- hier kernel
@pytest.mark.parametrize("n_active", N_ACTIVE)
@pytest.mark.parametrize("chunk_words", CHUNK_WIDTHS)
def test_hier_schedule_covers_every_stored_word_once(chunk_words,
                                                     n_active):
    """Each walked position's units cover the words of its stored chunks
    once; positions follow one another in order (the prefix sum of their
    chunk counts), a vertex without stored chunks takes no unit."""
    v = 300
    _, indptr, indices = _graph(v, chunk_words, density=0.05)
    hb = build_hier_bitmap(v, indptr, indices, chunk_words=chunk_words)
    ptr = torch.from_numpy(hb.chunk_ptr)
    rng = np.random.default_rng(n_active)
    verts = torch.from_numpy(rng.integers(0, v, n_active))
    walk = refine_hier_schedule(ptr, verts, chunk_words)
    unit = min(chunk_words, 4)
    counts = ptr[verts + 1] - ptr[verts]
    assert walk.shape == (int(counts.sum()) * chunk_words // unit, 3)
    assert bool((walk[1:, 0] >= walk[:-1, 0]).all())
    for p in range(n_active):
        k0, k1 = int(ptr[verts[p]]), int(ptr[verts[p] + 1])
        mine = walk[walk[:, 0] == p]
        got = sorted((int(k), int(q) + j) for _, k, q in mine
                     for j in range(unit))
        assert got == [(k, j) for k in range(k0, k1)
                       for j in range(chunk_words)]


@pytest.mark.parametrize("n_active", [0, 1, 8, 9, 64])
@pytest.mark.parametrize("v,f,cw,seed", [
    (48, 6, 1, 0), (300, 8, 8, 1), (520, 6, 4, 2), (64, 3, 16, 3),
    (100, 4, 2, 4), (300, 4, 128, 5)])
def test_hier_by_schedule_matches_plain_and_pallas(v, f, cw, seed,
                                                   n_active):
    """Rows past V - 1 follow the reference's kernel (``summary[V-1]``,
    no chunk), as the plain version does."""
    _, indptr, indices = _graph(v, seed)
    hb = jgraph.build_hier_bitmap(v, indptr, indices, chunk_words=cw)
    lanes = [hb.summary, hb.chunk_ptr, hb.chunk_id, hb.chunk_data]
    cand, frontier, active = _rows(v, f, 64, n_active, seed)
    args = (*map(_i32, lanes), _i32(cand), _i32(frontier), _i32(active))
    got = refine_rows_hier_by_schedule(*args)
    want = refine_bitmap_rows_hier_ref(*args[:4], hb.kmax, *args[4:])
    assert torch.equal(got, want)
    pallas = np.asarray(refine_bitmap_rows_hier_op(
        *map(jnp.asarray, lanes), hb.kmax, jnp.asarray(cand),
        jnp.asarray(frontier), jnp.asarray(active),
        backend="pallas_interpret")).view(np.int32)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_hier_by_schedule_all_dead_rows_are_zeros():
    """A row whose candidates live only in chunks its active vertex has
    no neighbour in is all zeros, and so is an all-zero cand row."""
    v, cw = 520, 4
    _, indptr, indices = _graph(v, 9, density=0.02)
    hb = build_hier_bitmap(v, indptr, indices, chunk_words=cw)
    lanes = [_i32(a) for a in (hb.summary, hb.chunk_ptr, hb.chunk_id,
                               hb.chunk_data)]
    rng = np.random.default_rng(9)
    f, w = 8, (v + 31) // 32
    n_chunks = -(-w // cw)
    gaps = np.nonzero((hb.summary[:, 0] & (1 << n_chunks) - 1)
                      != (1 << n_chunks) - 1)[0]      # a chunk not stored
    frontier = np.full((f, 4), -1, np.int32)
    frontier[:, 0] = rng.choice(gaps, f)
    active = np.zeros((f, 4), np.int32)
    active[:, 0] = 1
    cand = np.zeros((f, w), np.int32)
    for i in range(0, f, 2):
        s = int(hb.summary[frontier[i, 0], 0])
        dead = [c for c in range(n_chunks) if not (s >> c) & 1]
        cand[i, cw * dead[0]:cw * dead[0] + cw] = -1
    args = (*lanes, _i32(cand), _i32(frontier), _i32(active))
    got = refine_rows_hier_by_schedule(*args)
    assert not got.any()
    assert torch.equal(got, refine_bitmap_rows_hier_ref(*lanes, hb.kmax,
                                                        *args[4:]))
