"""The decomposition of the port's SpMM kernel, on the CPU.

The kernel (``csrc/bitmap_spmm.cu``) runs only on the card
(``tests/test_torch_cuda.py``, where it equals its emulation bit for
bit). Here ``ref.bitmap_spmm_split_ref`` — the same decomposition in the
same f32 operations: each row's set-bit list cut into per-warp slices
(passes of the row, windows of the shared list), each slice added in
order into a TwoSum pair, the pairs combined in warp order — is
held against the JAX package's Pallas SpMM in interpret mode
(``repro.kernels.ops.bitmap_spmm_op(..., backend="pallas_interpret")``)
and against the port's plain f64 version, on the same numpy inputs made
from a seed: rtol / atol 1e-5 in f32, 2e-2 in bf16 (the reference's
tolerances). The order itself (``ref.spmm_split_schedule``) is pinned
against a direct definition, since TwoSum makes the sums nearly
order-free; and ``bitmap_spmm.plan``, which picks the route from the
shape alone, is pinned case by case.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.graph import pack_bitmap
from repro.data.graph_gen import human_like_graph
from repro.kernels import ops as jops
from repro_torch.kernels import bitmap_spmm
from repro_torch.kernels.bitmap_spmm import (LONG_ROW_WORDS, SPLIT_MAX_COLS,
                                             plan)
from repro_torch.kernels.ref import (bitmap_spmm_ref, bitmap_spmm_split_ref,
                                     spmm_split_schedule)

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
TOL = {F32: 1e-5, BF16: 2e-2}


def _rows(w, seed):
    """A 0/1 matrix of 32 W columns whose rows are the edge cases: a hub
    of 700 set bits (the scale graph's largest degree is 692), one set
    bit, only bit 31 of a word, none, and seven bits (slices of 2, 2, 2
    and 1 over four warps)."""
    rng = np.random.default_rng(seed)
    m = 32 * w
    dense = np.zeros((5, m), bool)
    dense[0, rng.choice(m, 700, replace=False)] = True
    dense[1, rng.integers(m)] = True
    dense[2, 32 * (w // 2) + 31] = True
    dense[4, rng.choice(m, 7, replace=False)] = True
    return dense


def _x(m, d, seed):
    return np.random.default_rng(seed).standard_normal((m, d)).astype(
        np.float32)


def _pallas(dense, x, dtype):
    """The reference's Pallas SpMM in interpret mode, as f32 numpy."""
    n, m = dense.shape
    out = jops.bitmap_spmm_op(jnp.asarray(pack_bitmap(dense)),
                              jnp.asarray(x, dtype),
                              backend="pallas_interpret",
                              block_i=8 * -(-n // 8), block_j=m)
    return np.asarray(out.astype(jnp.float32))


def _words(dense):
    return torch.from_numpy(pack_bitmap(dense).view(np.int32))


def _emulate(words, x):
    """The emulation in the layout of the route ``plan`` gives."""
    return bitmap_spmm_split_ref(words, x, groups=bitmap_spmm.row_slices(
        plan(words.shape, x.shape, x.dtype)))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=max(tol, 1e-5))


# ---------------------------------------------------------------- numbers
def _x_exact(m, d, seed):
    """x on a grid of 1/16 in [-4, 4]: exact in bf16, and every sum of up
    to 2**18 of them exact in f32 in any order, so the Pallas kernel's
    f32 sum is the exact one too."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-64, 65, (m, d)) / 16).astype(np.float32)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [1, 128, 129])
def test_split_emulation_matches_pallas_and_plain(d, dtype):
    dense = _rows(24, d)
    x = _x_exact(dense.shape[1], d, d + 1)
    words = _words(dense)
    xt = torch.from_numpy(x).to(dtype)
    got = _emulate(words, xt)
    assert got.dtype == dtype and got.shape == (5, d)
    assert not bool(got[3].any())                      # the empty row
    _close(got.float(), _pallas(dense, x, {F32: jnp.float32,
                                           BF16: jnp.bfloat16}[dtype]),
           dtype)
    _close(got.float(), bitmap_spmm_ref(words, xt).float(), dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [1, 128, 129])
def test_split_emulation_normal_x_matches_plain(d, dtype):
    """Standard normal x: the hub row's sums cancel to near zero, where
    only a sum that carries its rounding error stays within 1e-5 of the
    exact (f64) one; the rows of a few bits also match the Pallas
    kernel."""
    dense = _rows(24, d)
    x = _x(dense.shape[1], d, d + 2)
    words = _words(dense)
    xt = torch.from_numpy(x).to(dtype)
    got = _emulate(words, xt)
    _close(got.float(), bitmap_spmm_ref(words, xt).float(), dtype)
    pallas = _pallas(dense, x, {F32: jnp.float32, BF16: jnp.bfloat16}[dtype])
    _close(got.float()[1:], pallas[1:], dtype)


def test_pallas_f32_hub_row_drifts_past_the_tolerance():
    """Not a fault of the port: the reference's Pallas kernel sums in f32
    without an error term, and on a hub row of 700 standard normal values
    its result leaves rtol / atol 1e-5 of the exact sum where that sum
    cancels to near zero (here made so: one x value of the row takes away
    the rest's sum), while the emulation (and the kernel) stay inside. So
    a hub row is held to the Pallas kernel only on x whose f32 sums are
    exact (above)."""
    dense = _rows(24, 128)[:1]
    x = _x(dense.shape[1], 128, 130)
    cols = np.flatnonzero(dense[0])
    x[cols[0]] -= x[cols].astype(np.float64).sum(0).astype(np.float32)
    words, xt = _words(dense), torch.from_numpy(x)
    exact = bitmap_spmm_ref(words, xt).numpy()
    pallas = _pallas(dense, x, jnp.float32)
    assert (np.abs(pallas - exact) > 1e-5 + 1e-5 * np.abs(exact)).any()
    _close(bitmap_spmm_split_ref(words, xt), exact, F32)


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_split_emulation_hub_row_every_split(groups):
    """One row of 700 set bits (N 1) summed in 1-8 slices: each within
    1e-5 of the Pallas kernel."""
    dense = _rows(24, 7)[:1]
    x = _x_exact(dense.shape[1], 128, 8)
    got = bitmap_spmm_split_ref(_words(dense), torch.from_numpy(x),
                                groups=groups)
    _close(got, _pallas(dense, x, jnp.float32), F32)


def test_split_emulation_windows_and_passes():
    """Rows of 2101 words (five passes of 512) with ~4000 set bits and
    bit 31 of every word set on every third row (those rows' passes take
    two windows of the 1024-entry list)."""
    rng = np.random.default_rng(21)
    dense = rng.random((4, 32 * 2101)) < 0.06
    dense[::3, 31::32] = True
    assert dense[0, :32 * 512].sum() > 1024
    x = _x_exact(dense.shape[1], 16, 22)
    words = _words(dense)
    got = bitmap_spmm_split_ref(words, torch.from_numpy(x))
    _close(got, _pallas(dense, x, jnp.float32), F32)
    _close(got, bitmap_spmm_ref(words, torch.from_numpy(x)), F32)


def test_split_emulation_human_like_adjacency():
    """The matcher's packed adjacency (4674 rows, W 147, hub rows up to
    408 set bits) at D 8, against the plain f64 version."""
    words = torch.from_numpy(human_like_graph(seed=0).adj_bitmap.view(
        np.int32))
    x = torch.from_numpy(_x(32 * words.shape[1], 8, 3))
    _close(bitmap_spmm_split_ref(words, x), bitmap_spmm_ref(words, x), F32)


# ---------------------------------------------------------------- order
def _schedule_by_definition(dense, groups, pass_words, window):
    """Group g's sequence of each row, straight from the definition."""
    out = []
    for row in dense:
        seqs = [[] for _ in range(groups)]
        w = len(row) // 32
        for p0 in range(0, w, pass_words):
            bits = np.flatnonzero(row[32 * p0:32 * (p0 + pass_words)]) \
                + 32 * p0
            for k in range(0, len(bits), window):
                seg = bits[k:k + window]
                span = -(-len(seg) // groups)
                for g in range(groups):
                    seqs[g] += seg[g * span:(g + 1) * span].tolist()
        out.append(seqs)
    return out


@pytest.mark.parametrize("groups,pass_words,window", [
    (4, 2048, 1024), (3, 4, 16), (1, 4, 16), (8, 2, 5)])
def test_schedule_follows_the_definition(groups, pass_words, window):
    rng = np.random.default_rng(groups + window)
    dense = rng.random((6, 32 * 9)) < 0.4
    dense[2] = False
    dense[4, 31::32] = True
    idx = spmm_split_schedule(_words(dense), groups, pass_words, window)
    want = _schedule_by_definition(dense, groups, pass_words, window)
    assert idx.shape[:2] == (6, groups)
    for i in range(6):
        for g in range(groups):
            seq = idx[i, g].tolist()
            n = len(want[i][g])
            assert seq[:n] == want[i][g]
            assert all(c == dense.shape[1] for c in seq[n:])


def test_schedule_every_set_bit_once():
    """Every set bit of every row appears once across its groups, a
    hub row's 700 split four ways in slices of 175."""
    dense = _rows(24, 5)
    idx = spmm_split_schedule(_words(dense))
    for i, row in enumerate(dense):
        got = sorted(c for c in idx[i].reshape(-1).tolist()
                     if c != dense.shape[1])
        assert got == np.flatnonzero(row).tolist()
    hub = idx[0]
    assert [int((hub[g] != dense.shape[1]).sum()) for g in range(4)] == \
        [175] * 4


# ---------------------------------------------------------------- plan
@pytest.mark.parametrize("words_shape,x_shape,want", [
    ((4674, 147), (4704, 128), "split"),     # (a) human
    ((65536, 2048), (65536, 128), "stream"),  # (c) scale
    ((2708, 85), (2720, 1433), "wide"),       # (b) Cora
    ((1, 147), (4704, 1), "split"),           # N 1, D 1
    ((4674, 147), (4704, 129), "wide"),       # D 129
    ((50, 1), (32, 8), "split"),              # M 32
    ((10, 512), (16384, 64), "split"),
    ((10, 513), (16416, 64), "stream"),       # a long row
    ((10, 1024), (32768, 64), "stream"),
    ((10, 2101), (67232, 64), "stream"),
    ((10, 3), (96, 4096), "wide"),
])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plan_routes(words_shape, x_shape, want, dtype):
    assert plan(words_shape, x_shape, dtype) == want
    if want != "wide":
        assert x_shape[1] <= SPLIT_MAX_COLS


def test_plan_long_rows_stream_short_rows_split():
    """Rows of up to LONG_ROW_WORDS words split over four warps; longer
    ones (the scale graph's 2048) stream, a warp per row, summed in one
    sequence; wider D takes the wide route whatever the row."""
    assert plan((8, LONG_ROW_WORDS), (32 * LONG_ROW_WORDS, 128), F32) \
        == "split"
    assert plan((8, LONG_ROW_WORDS + 1), (32 * LONG_ROW_WORDS + 32, 128),
                F32) == "stream"
    assert plan((8, 4096), (131072, 129), BF16) == "wide"
    assert [bitmap_spmm.row_slices(r) for r in ("split", "stream", "wide")] \
        == [4, 1, 1]


def test_plan_raises_for_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        plan((4, 2), (64, 8), torch.float16)


def test_cpu_calls_count_no_route():
    dense = _rows(24, 1)
    words, x = _words(dense), torch.from_numpy(_x(768, 8, 2))
    before = dict(bitmap_spmm.SPMM_ROUTES)
    launches = bitmap_spmm.SPMM_LAUNCHES
    out = bitmap_spmm.bitmap_spmm(words, x)
    assert torch.equal(out, bitmap_spmm_ref(words, x))
    assert bitmap_spmm.SPMM_ROUTES == before
    assert bitmap_spmm.SPMM_LAUNCHES == launches
