"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and the CUDA toolkit, and
skips without a card; the file imports neither JAX nor ``repro``, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Inputs come from numpy with a seed. The refine kernels are integer AND
over packed words: their output must equal the plain version bit for
bit (``torch.equal``, no tolerance). The SpMM and attention kernels sum
in another order than their plain versions: f32 within rtol / atol 1e-5
(SpMM) and 2e-4 (attention), the reference's own tolerances; bf16 SpMM
within 2e-2, and bf16 attention within rtol 2e-2 with an atol of two
bf16 units of each output row's largest value (a flat 2e-2 would exceed
the outputs of a long softmax). The SpMM kernel also equals, bit for
bit, ``ref.bitmap_spmm_split_ref`` run on the card: the CPU emulation of
its decomposition, in the same f32 operations and order. The model zoo
(``repro_torch.models``) runs on the card against the CPU: the smoke
configs of a dense LM and of DeepSeek in float32, one set of weights on
both, within the port's f32 rule (rtol 1e-4, atol 1e-5, TF32 off).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.graph import build_hier_bitmap
from repro_torch.core.graph import pack_bitmap
from repro_torch.kernels import (bitmap_refine, bitmap_spmm, flash_attention,
                                 ops)
from repro_torch.kernels.ref import (bitmap_spmm_ref,
                                     bitmap_spmm_split_ref,
                                     flash_attention_ref,
                                     refine_bitmap_rows_hier_ref,
                                     refine_bitmap_rows_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU "
                    "mode); run this file on the card")
    return torch.device("cuda")


def _inputs(v, f, np_, seed):
    rng = np.random.default_rng(seed)
    w = (v + 31) // 32
    adj = rng.integers(-2**31, 2**31, (v, w), dtype=np.int64)
    adj = (adj | rng.integers(-2**31, 2**31, (v, w), dtype=np.int64))
    cand = rng.integers(-2**31, 2**31, (f, w), dtype=np.int64)
    frontier = rng.integers(-1, v + 3, (f, np_))
    active = (rng.random((f, np_)) < 0.6).astype(np.int32)
    return [torch.from_numpy(a.astype(np.int32))
            for a in (adj, cand, frontier, active)]


@pytest.mark.parametrize("v,f,np_,seed", [
    (48, 3, 6, 0), (200, 21, 9, 2), (520, 40, 12, 3), (4674, 512, 64, 4),
    (33, 1, 64, 5)])
def test_cuda_refine_kernel_matches_plain(cuda_device, v, f, np_, seed):
    args = [t.to(cuda_device) for t in _inputs(v, f, np_, seed)]
    before = bitmap_refine.LAUNCHES
    got = bitmap_refine.refine_bitmap_rows(*args)
    torch.cuda.synchronize()
    assert bitmap_refine.LAUNCHES == before + 1
    assert torch.equal(got, refine_bitmap_rows_ref(*args))


def test_cuda_refine_kernel_rejects_bad_inputs(cuda_device):
    adj, cand, frontier, active = [t.to(cuda_device)
                                   for t in _inputs(64, 4, 8, 6)]
    with pytest.raises(TypeError):
        bitmap_refine.refine_bitmap_rows(adj, cand.long(), frontier, active)
    with pytest.raises(ValueError):
        bitmap_refine.refine_bitmap_rows(adj, cand[:, :1], frontier, active)
    with pytest.raises(ValueError):
        bitmap_refine.refine_bitmap_rows(adj, cand, frontier.cpu(), active)


def test_cuda_refine_kernels_refuse_a_dtensor(cuda_device):
    """A card ``DTensor`` (whose ``data_ptr()`` is 0) raises
    ``TypeError`` at either refine entry point, with no launch."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch import mesh as T_MESH
    adj, cand, frontier, active = [t.to(cuda_device)
                                   for t in _inputs(64, 4, 8, 6)]
    lanes, kmax, _ = _hier_inputs(64, 4, 8, 4, 6)
    lanes = [t.to(cuda_device) for t in lanes]
    T_MESH.init_fake_group(1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("model",))
        d_cand = DTensor.from_local(cand, mesh, [Replicate()],
                                    run_check=False)
        before = (bitmap_refine.LAUNCHES, bitmap_refine.HIER_LAUNCHES)
        with pytest.raises(TypeError, match="cand_rows"):
            bitmap_refine.refine_bitmap_rows(adj, d_cand, frontier, active)
        with pytest.raises(TypeError, match="cand_rows"):
            bitmap_refine.refine_bitmap_rows_hier(*lanes, kmax, d_cand,
                                                  frontier, active)
        torch.cuda.synchronize()
        assert (bitmap_refine.LAUNCHES,
                bitmap_refine.HIER_LAUNCHES) == before
    finally:
        dist.destroy_process_group()


def _hier_inputs(v, f, np_, cw, seed):
    """A random symmetric graph's two-level layout and refine inputs,
    with ``-1``, past-V and all-inactive rows among them."""
    rng = np.random.default_rng(seed)
    dense = rng.random((v, v)) < 0.2
    dense |= dense.T
    indptr = np.concatenate(([0], np.cumsum(dense.sum(axis=1))))
    hb = build_hier_bitmap(v, indptr, np.nonzero(dense)[1], chunk_words=cw)
    w = (v + 31) // 32
    cand = rng.integers(-2**31, 2**31, (f, w), dtype=np.int64)
    frontier = rng.integers(-1, v + 3, (f, np_))
    active = (rng.random((f, np_)) < 0.6).astype(np.int32)
    active[::5] = 0
    lanes = [hb.summary.view(np.int32), hb.chunk_ptr, hb.chunk_id,
             hb.chunk_data.view(np.int32)]
    return ([torch.from_numpy(a) for a in lanes], hb.kmax,
            [torch.from_numpy(a.astype(np.int32))
             for a in (cand, frontier, active)])


@pytest.mark.parametrize("v,f,np_,cw,seed", [
    (48, 6, 5, 1, 0), (300, 16, 8, 8, 1), (520, 24, 9, 4, 2),
    (64, 1, 3, 16, 3), (4096, 512, 64, 8, 4)])
def test_cuda_hier_refine_kernel_matches_plain(cuda_device, v, f, np_, cw,
                                               seed):
    lanes, kmax, rows = _hier_inputs(v, f, np_, cw, seed)
    args = ([t.to(cuda_device) for t in lanes], kmax,
            [t.to(cuda_device) for t in rows])
    before = bitmap_refine.HIER_LAUNCHES
    got = bitmap_refine.refine_bitmap_rows_hier(*args[0], kmax, *args[2])
    torch.cuda.synchronize()
    assert bitmap_refine.HIER_LAUNCHES == before + 1
    assert torch.equal(got, refine_bitmap_rows_hier_ref(*args[0], kmax,
                                                        *args[2]))


def test_cuda_hier_refine_kernel_rejects_bad_inputs(cuda_device):
    lanes, kmax, (cand, frontier, active) = _hier_inputs(64, 4, 8, 4, 6)
    lanes = [t.to(cuda_device) for t in lanes]
    cand, frontier, active = (t.to(cuda_device)
                              for t in (cand, frontier, active))
    refine = bitmap_refine.refine_bitmap_rows_hier
    with pytest.raises(TypeError):
        refine(*lanes, kmax, cand.long(), frontier, active)
    with pytest.raises(ValueError):
        refine(*lanes[:3], lanes[3][:, :3].contiguous(), kmax, cand,
               frontier, active)
    with pytest.raises(ValueError):
        refine(*lanes, kmax, cand, frontier.cpu(), active)


def _active_rows(rng, v, f, np_, n_active):
    """frontier / active with exactly ``n_active`` active positions a
    row, among them -1 lanes (every third row) and vertices past V - 1
    (odd rows)."""
    frontier = rng.integers(0, v, (f, np_)).astype(np.int32)
    active = np.zeros((f, np_), np.int32)
    for i in range(f):
        active[i, rng.choice(np_, n_active, replace=False)] = 1
    if np_ > 1:
        frontier[::3, 0] = -1
        frontier[1::2, 1] = v + 5
    return torch.from_numpy(frontier), torch.from_numpy(active)


@pytest.mark.parametrize("n_active", [0, 1, 7, 8, 9, 64])
@pytest.mark.parametrize("v,w", [(300, 147), (64, 3), (40, 8192)])
def test_cuda_refine_kernel_positions_and_widths(cuda_device, v, w,
                                                 n_active):
    """0 to 64 active positions (one group of 8 gathers, two, eight), on
    147-word rows (each row at another word offset of the 16-byte grid),
    3-word rows and 8192-word rows (52 tiles)."""
    rng = np.random.default_rng(v + n_active)
    adj = torch.from_numpy(rng.integers(-2**31, 2**31, (v, w),
                                        dtype=np.int64).astype(np.int32))
    cand = torch.from_numpy(rng.integers(-2**31, 2**31, (9, w),
                                         dtype=np.int64).astype(np.int32))
    frontier, active = _active_rows(rng, v, 9, 64, n_active)
    args = [t.to(cuda_device) for t in (adj, cand, frontier, active)]
    got = bitmap_refine.refine_bitmap_rows(*args)
    assert torch.equal(got, refine_bitmap_rows_ref(*args))


@pytest.mark.parametrize("offset", range(4))
def test_cuda_refine_kernel_at_each_alignment(cuda_device, offset):
    """cand starting ``offset`` words past a 16-byte boundary: scalar
    loads and stores (out is aligned, cand is not), the same bits; and
    out and cand sharing that offset (both views): head, body and tail on
    the offset grid."""
    adj, cand, frontier, active = [t.to(cuda_device)
                                   for t in _inputs(4674, 64, 64, 8)]
    want = refine_bitmap_rows_ref(adj, cand, frontier, active)
    buf = torch.empty(cand.numel() + 4, dtype=torch.int32,
                      device=cuda_device)
    view = buf[offset:offset + cand.numel()].view(cand.shape)
    view.copy_(cand)
    assert view.data_ptr() % 16 == 4 * offset
    assert torch.equal(bitmap_refine.refine_bitmap_rows(
        adj, view, frontier, active), want)
    lib = bitmap_refine._library("refine_bitmap_rows")
    out = torch.zeros_like(buf)
    out_view = out[offset:offset + cand.numel()].view(cand.shape)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    assert lib.refine_bitmap_rows_launch(
        adj.data_ptr(), view.data_ptr(), frontier.data_ptr(),
        active.data_ptr(), out_view.data_ptr(), adj.shape[0], adj.shape[1],
        cand.shape[0], frontier.shape[1], stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out_view, want)
    assert not out[:offset].any() and not out[offset + cand.numel():].any()


def _hier_layout(v, cw, seed, density=0.2):
    rng = np.random.default_rng(seed)
    dense = rng.random((v, v)) < density
    dense |= dense.T
    indptr = np.concatenate(([0], np.cumsum(dense.sum(axis=1))))
    hb = build_hier_bitmap(v, indptr, np.nonzero(dense)[1], chunk_words=cw)
    return hb, [torch.from_numpy(a) for a in (
        hb.summary.view(np.int32), hb.chunk_ptr, hb.chunk_id,
        hb.chunk_data.view(np.int32))]


@pytest.mark.parametrize("n_active", [0, 1, 8, 9, 64])
@pytest.mark.parametrize("v,cw", [(520, 4), (300, 1), (300, 2),
                                  (1000, 128), (4096, 8)])
def test_cuda_hier_refine_kernel_positions_and_chunks(cuda_device, v, cw,
                                                      n_active):
    """0 to 64 active positions (past-V and -1 lanes among them) at chunk
    widths 1, 2, 4, 8 and 128 (wider than the row)."""
    hb, lanes = _hier_layout(v, cw, v + cw)
    rng = np.random.default_rng(n_active)
    w = (v + 31) // 32
    cand = torch.from_numpy(rng.integers(-2**31, 2**31, (33, w),
                                         dtype=np.int64).astype(np.int32))
    frontier, active = _active_rows(rng, v, 33, 64, n_active)
    args = [t.to(cuda_device) for t in (*lanes, cand, frontier, active)]
    got = bitmap_refine.refine_bitmap_rows_hier(*args[:4], hb.kmax,
                                                *args[4:])
    assert torch.equal(got, refine_bitmap_rows_hier_ref(
        *args[:4], hb.kmax, *args[4:]))


def test_cuda_hier_refine_kernel_all_dead_and_wide_rows(cuda_device):
    """Rows whose summary intersection is all dead are zeros, and a
    262144-vertex power-law graph (8192-word rows, a 32 KB shared row)
    equals the plain version."""
    from repro_torch.data.graph_gen import powerlaw_graph
    hb, lanes = _hier_layout(520, 4, 7, density=0.004)
    rng = np.random.default_rng(7)
    n_chunks = 5
    gaps = np.nonzero((hb.summary[:, 0] & 31) != 31)[0]
    frontier = np.full((16, 4), -1, np.int32)
    frontier[:, 0] = rng.choice(gaps, 16)
    active = np.zeros((16, 4), np.int32)
    active[:, 0] = 1
    cand = np.zeros((16, 17), np.int32)
    for i in range(0, 16, 2):
        s = int(hb.summary[frontier[i, 0], 0])
        dead = [c for c in range(n_chunks) if not (s >> c) & 1][0]
        cand[i, 4 * dead:4 * dead + 4] = -1
    args = [t.to(cuda_device) for t in (
        *lanes, *map(torch.from_numpy, (cand, frontier, active)))]
    got = bitmap_refine.refine_bitmap_rows_hier(*args[:4], hb.kmax,
                                                *args[4:])
    assert not got.any()
    big = powerlaw_graph(262144, 3, 16, seed=0).hier_bitmap(8)
    lanes = [torch.from_numpy(a).to(cuda_device) for a in (
        big.summary.view(np.int32), big.chunk_ptr, big.chunk_id,
        big.chunk_data.view(np.int32))]
    rng = np.random.default_rng(8)
    frontier, active = _active_rows(rng, 262144, 64, 64, 5)
    frontier[::2, 2] = torch.from_numpy(rng.integers(0, 64, 32))  # hubs
    active[::2, 2] = 1
    cand = torch.from_numpy(rng.integers(-2**31, 2**31, (64, 8192),
                                         dtype=np.int64).astype(np.int32))
    rows = [t.to(cuda_device) for t in (cand, frontier, active)]
    got = bitmap_refine.refine_bitmap_rows_hier(*lanes, big.kmax, *rows)
    assert torch.equal(got, refine_bitmap_rows_hier_ref(*lanes, big.kmax,
                                                        *rows))


def test_cuda_refine_kernels_are_deterministic(cuda_device):
    """Repeated calls give the same bits (the hier kernel ANDs with
    shared-memory atomics, in an order that changes from run to run)."""
    lanes, kmax, rows = _hier_inputs(4096, 512, 64, 8, 4)
    args = [t.to(cuda_device) for t in (*lanes, *rows)]
    first = bitmap_refine.refine_bitmap_rows_hier(*args[:4], kmax,
                                                  *args[4:])
    dense = [t.to(cuda_device) for t in _inputs(4674, 512, 64, 4)]
    first_dense = bitmap_refine.refine_bitmap_rows(*dense)
    for _ in range(3):
        assert torch.equal(bitmap_refine.refine_bitmap_rows_hier(
            *args[:4], kmax, *args[4:]), first)
        assert torch.equal(bitmap_refine.refine_bitmap_rows(*dense),
                           first_dense)


def test_cuda_refine_kernels_take_strided_views(cuda_device):
    """A strided (non-contiguous) input gives the bits of its contiguous
    copy, on both refine kernels."""
    adj, cand, frontier, active = [t.to(cuda_device)
                                   for t in _inputs(520, 40, 12, 3)]
    wide = torch.zeros((40, 2 * cand.shape[1]), dtype=torch.int32,
                       device=cuda_device)
    wide[:, ::2] = cand
    views = [wide[:, ::2], frontier.t().contiguous().t()]
    assert not any(t.is_contiguous() for t in views)
    assert torch.equal(
        bitmap_refine.refine_bitmap_rows(adj, views[0], views[1], active),
        bitmap_refine.refine_bitmap_rows(adj, cand, frontier, active))
    lanes, kmax, rows = _hier_inputs(520, 24, 9, 4, 2)
    lanes = [t.to(cuda_device) for t in lanes]
    cand, frontier, active = (t.to(cuda_device) for t in rows)
    want = bitmap_refine.refine_bitmap_rows_hier(*lanes, kmax, cand,
                                                 frontier, active)
    views = [t.t().contiguous().t() for t in (lanes[3], cand)]
    assert not any(t.is_contiguous() for t in views)
    assert torch.equal(bitmap_refine.refine_bitmap_rows_hier(
        *lanes[:3], views[0], kmax, views[1], frontier, active), want)


def _spmm_inputs(n, w, d, density, seed, dtype):
    rng = np.random.default_rng(seed)
    dense = rng.random((n, 32 * w)) < density
    dense[::3, 31::32] = True                 # bit 31: negative int32 words
    words = torch.from_numpy(pack_bitmap(dense).view(np.int32))
    x = torch.from_numpy(rng.standard_normal((32 * w, d)).astype(np.float32))
    return words, x.to(dtype)


# n, w, d, density: small and human-like shapes, then a hub of ~700 set
# bits (the scale graph's largest degree), rows of 2048 words (the scale
# width) with ~6 set bits (every third row also has bit 31 of each word:
# 2048 more, several list windows) and the Cora width
SPMM_CASES = [
    (1, 1, 1, 0.3), (33, 3, 129, 0.3), (200, 5, 16, 0.01),
    (97, 2, 600, 0.2), (130, 147, 128, 0.008),
    (4, 32, 128, 0.68), (8, 2048, 128, 6 / 65536), (64, 85, 1433, 0.0015)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,w,d,density", SPMM_CASES)
def test_cuda_spmm_kernel_matches_plain(cuda_device, n, w, d, density,
                                        dtype):
    words, x = (t.to(cuda_device) for t in _spmm_inputs(
        n, w, d, density, n + d, dtype))
    before = bitmap_spmm.SPMM_LAUNCHES
    got = bitmap_spmm.bitmap_spmm(words, x)
    torch.cuda.synchronize()
    assert bitmap_spmm.SPMM_LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (n, d)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), bitmap_spmm_ref(words, x).float(),
                               rtol=tol, atol=tol if tol > 1e-5 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,w,d,density", [
    (4, 32, 128, 0.68),          # split, 4 warps: a hub row, slices of 174
    (8, 2048, 128, 6 / 65536),   # stream: 8 windows on the bit-31 rows
    (5, 2101, 64, 0.03),         # stream: five passes, unaligned rows
    (6, 7, 3, 0.5),              # split: slices that do not divide
    (64, 85, 1433, 0.0015),      # wide: three column tiles
    (40, 3, 129, 0.3)])          # wide: one tile, 129 of its 512 columns
def test_cuda_spmm_kernel_equals_its_emulation(cuda_device, n, w, d,
                                               density, dtype):
    """The kernel and ``bitmap_spmm_split_ref`` (its decomposition, in
    f32, on the same card) agree bit for bit on either route."""
    words, x = (t.to(cuda_device) for t in _spmm_inputs(
        n, w, d, density, n + w, dtype))
    route = bitmap_spmm.plan(words.shape, x.shape, dtype)
    got = bitmap_spmm.bitmap_spmm(words, x)
    want = bitmap_spmm_split_ref(words, x,
                                 groups=bitmap_spmm.row_slices(route))
    assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["split", "stream", "wide"])
@pytest.mark.parametrize("n,w,d,density", [
    (4, 32, 128, 0.68),          # hub rows of ~700 set bits
    (5, 2101, 64, 0.03),         # several passes of each route, unaligned
    (40, 3, 129, 0.3)])          # two column tiles of split and stream
def test_cuda_spmm_every_route_takes_any_shape(cuda_device, route, n, w, d,
                                               density):
    """Each route, launched off its plan (as ``scripts/spmm_sweep.py``
    times them), is within tolerance of the plain version and equals its
    emulation bit for bit."""
    words, x = (t.to(cuda_device) for t in _spmm_inputs(
        n, w, d, density, n + w, torch.float32))
    got = bitmap_spmm._launch(words, x, route)
    torch.testing.assert_close(got, bitmap_spmm_ref(words, x), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, bitmap_spmm_split_ref(
        words, x, groups=bitmap_spmm.row_slices(route)))


def test_cuda_spmm_kernel_is_deterministic(cuda_device):
    """Repeated calls give the same bits: no atomics, no order that
    depends on timing (hub rows of ~700 bits split over four warps)."""
    words, x = (t.to(cuda_device) for t in _spmm_inputs(
        300, 24, 128, 0.3, 3, torch.float32))
    first = bitmap_spmm.bitmap_spmm(words, x)
    for _ in range(3):
        assert torch.equal(bitmap_spmm.bitmap_spmm(words, x), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_spmm_unaligned_views_change_no_bit(cuda_device, dtype):
    """Words and x that are not 16-byte aligned take scalar loads; the
    result is the aligned one, bit for bit."""
    words, x = (t.to(cuda_device) for t in _spmm_inputs(
        9, 2048, 64, 0.001, 4, dtype))
    want = bitmap_spmm.bitmap_spmm(words[1:].contiguous(), x)
    wbuf = torch.empty(words.numel() + 1, dtype=torch.int32,
                       device=cuda_device)
    wbuf[1:] = words.reshape(-1)
    xbuf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)
    xbuf[1:] = x.reshape(-1)
    w_odd = wbuf[1:].view(words.shape)[1:]
    x_odd = xbuf[1:].view(x.shape)
    assert w_odd.data_ptr() % 16 and x_odd.data_ptr() % 8
    assert torch.equal(bitmap_spmm.bitmap_spmm(w_odd, x_odd), want)


def test_cuda_spmm_kernel_takes_strided_views(cuda_device):
    """Strided words and x give the bits of their contiguous copies."""
    words, x = (t.to(cuda_device) for t in _spmm_inputs(
        33, 3, 129, 0.3, 5, torch.float32))
    want = bitmap_spmm.bitmap_spmm(words, x)
    words_t = words.t().contiguous().t()
    x_t = x.t().contiguous().t()
    assert not words_t.is_contiguous() and not x_t.is_contiguous()
    assert torch.equal(bitmap_spmm.bitmap_spmm(words_t, x_t), want)


def test_cuda_spmm_routes_are_counted(cuda_device):
    """Each route launches and is counted once per call, with one launch
    in ``SPMM_LAUNCHES``: D 128 takes ``split`` on short rows and
    ``stream`` on long ones, D 129 ``wide``."""
    launches = bitmap_spmm.SPMM_LAUNCHES
    for w, d, route in ((4, 128, "split"), (4, 129, "wide"),
                        (4, 1433, "wide"), (4, 1, "split"),
                        (1025, 128, "stream"), (2048, 3, "stream")):
        words, x = (t.to(cuda_device) for t in _spmm_inputs(
            20, w, d, 0.2 if w < 100 else 0.001, d, torch.float32))
        before = dict(bitmap_spmm.SPMM_ROUTES)
        bitmap_spmm.bitmap_spmm(words, x)
        taken = {r: c - before[r] for r, c in bitmap_spmm.SPMM_ROUTES.items()
                 if c != before[r]}
        assert taken == {route: 1}
    assert bitmap_spmm.SPMM_LAUNCHES == launches + 6


def test_cuda_spmm_kernel_rejects_bad_inputs(cuda_device):
    words, x = (t.to(cuda_device) for t in _spmm_inputs(
        8, 2, 4, 0.3, 0, torch.float32))
    with pytest.raises(TypeError):
        bitmap_spmm.bitmap_spmm(words.long(), x)
    with pytest.raises(TypeError):
        bitmap_spmm.bitmap_spmm(words, x.half())
    with pytest.raises(ValueError):
        bitmap_spmm.bitmap_spmm(words, x[:63])
    with pytest.raises(ValueError):
        bitmap_spmm.bitmap_spmm(words.cpu(), x)


def _flash_inputs(b, h, hkv, s, skv, d, seed, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(dtype)
            for shape in ((b, h, s, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def _flash_close(got, want, dtype):
    """f32 within 2e-4; bf16 within rtol 2e-2 plus two bf16 units
    (2**-8) of each row's largest output."""
    assert got.dtype == dtype
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        atol = 2 * 2.0 ** -8 * want.abs().amax(-1, keepdim=True)
        assert bool(((got - want).abs() <= atol + 2e-2 * want.abs()).all())


def _flash_route_run(q, k, v, causal, route):
    """One call, which must launch once on ``route``; returns its
    output."""
    before = dict(flash_attention.FLASH_ROUTES)
    launches = flash_attention.FLASH_LAUNCHES
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          block_q=q.shape[2],
                                          block_k=k.shape[2])
    torch.cuda.synchronize()
    assert flash_attention.FLASH_LAUNCHES == launches + 1
    before[route] += 1
    assert flash_attention.FLASH_ROUTES == before
    return got


# Routes on the card (tests/test_torch_flash_routes.py pins them): the
# first and fourth case take ``split`` in both dtypes; the second, third
# and fifth ``tc`` in bf16 and ``fma`` in f32; D 129 ``fma`` in both.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,skv,d,causal", [
    (1, 2, 2, 48, 48, 16, True),      # S not a multiple of the row tile
    (2, 8, 1, 64, 80, 64, True),      # group 8, causal with S < Skv
    (1, 4, 4, 96, 32, 48, True),      # S > Skv, D not a multiple of 32
    (1, 4, 2, 1, 300, 128, False),    # decode, ragged key tile
    (1, 2, 1, 40, 100, 256, True),    # D 256 (32-key tiles)
    (1, 2, 2, 33, 33, 129, False)])   # D 129, odd everything
def test_cuda_flash_kernel_matches_plain(cuda_device, b, h, hkv, s, skv, d,
                                         causal, dtype):
    q, k, v = (t.to(cuda_device) for t in _flash_inputs(
        b, h, hkv, s, skv, d, s + d, dtype))
    route = flash_attention.plan(q.shape, k.shape, dtype).route
    got = _flash_route_run(q, k, v, causal, route)
    _flash_close(got, flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("skv", [300, 32768])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("s", [1, 8])
def test_cuda_flash_split_route(cuda_device, s, group, skv, causal, dtype):
    """Decode-shaped calls: split-K with the GQA group folded in, at up
    to 64 rows per kv head (S 8, group 8), one split (Skv 300 at B 2,
    Hkv 2 takes two) or many (Skv 32768)."""
    q, k, v = (t.to(cuda_device) for t in _flash_inputs(
        2, 2 * group, 2, s, skv, 128, s * group + skv, dtype))
    got = _flash_route_run(q, k, v, causal, "split")
    _flash_close(got, flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("b,h,hkv,s,skv,d,causal", [
    (1, 4, 2, 200, 200, 64, True),       # ragged S and Skv tiles
    (1, 4, 2, 130, 333, 128, True),      # causal S < Skv, ragged
    (1, 2, 1, 300, 70, 256, True),       # causal S > Skv
    (2, 2, 2, 257, 129, 128, False),     # ragged, non-causal
    (1, 8, 8, 512, 512, 256, False),
    (1, 2, 2, 96, 96, 80, True),         # D 80, padded to 128 columns
    (1, 16, 8, 1024, 1024, 128, True),   # Qwen3-0.6B heads
    (1, 4, 4, 128, 64, 16, False)])      # D 16
def test_cuda_flash_tc_route(cuda_device, b, h, hkv, s, skv, d, causal):
    """bf16 prefill on the tensor cores (wgmma), against the plain
    version under the bf16 rule."""
    q, k, v = (t.to(cuda_device) for t in _flash_inputs(
        b, h, hkv, s, skv, d, s + skv + d, torch.bfloat16))
    got = _flash_route_run(q, k, v, causal, "tc")
    _flash_close(got, flash_attention_ref(q, k, v, causal=causal),
                 torch.bfloat16)


def test_cuda_flash_kernel_rejects_bad_inputs(cuda_device):
    q, k, v = (t.to(cuda_device) for t in _flash_inputs(
        1, 2, 1, 64, 64, 32, 0, torch.float32))
    big = [t.to(cuda_device) for t in _flash_inputs(
        1, 1, 1, 8, 8, 257, 0, torch.float32)]
    with pytest.raises(ValueError, match="256"):
        flash_attention.flash_attention(*big)
    with pytest.raises(ValueError, match="divide"):
        flash_attention.flash_attention(q, k, v, block_q=48)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q, k.bfloat16(), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernel_takes_strided_views(cuda_device, dtype):
    """q, k and v as [B, S, H, D] tensors seen as [B, H, S, D] (strided)
    give the bits of their contiguous copies."""
    q, k, v = (t.to(cuda_device) for t in _flash_inputs(
        1, 4, 2, 64, 64, 64, 1, dtype))
    want = flash_attention.flash_attention(q, k, v)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    assert not any(t.is_contiguous() for t in views)
    assert torch.equal(flash_attention.flash_attention(*views), want)


def test_cuda_per_call_torch_backend_runs_plain(cuda_device):
    """``backend="torch"`` on card tensors runs the plain version for
    that call only: no launch, and the next call launches again."""
    words, x = (t.to(cuda_device) for t in _spmm_inputs(
        40, 3, 8, 0.3, 1, torch.float32))
    before = bitmap_spmm.SPMM_LAUNCHES
    plain = ops.bitmap_spmm_op(words, x, backend="torch")
    assert bitmap_spmm.SPMM_LAUNCHES == before
    assert torch.equal(plain, bitmap_spmm_ref(words, x))
    ops.bitmap_spmm_op(words, x)
    torch.cuda.synchronize()
    assert bitmap_spmm.SPMM_LAUNCHES == before + 1


def test_cuda_tuning_space_reads_the_cards_limits(cuda_device):
    """On the card the space's hier budget is the kernel library's
    opt-in shared-memory limit, its dense budget a quarter of the card's
    memory, and the device kind the card's normalised name."""
    from repro_torch.tuning import device_kind
    from repro_torch.tuning.space import (DENSE_MEMORY_SHARE, TunableSpace,
                                          WorkloadShape)
    space = TunableSpace("cuda", WorkloadShape.for_graph(65536))
    assert space.smem_limit_bytes == bitmap_refine.hier_max_smem()
    assert space.smem_limit_bytes > 48 * 1024
    total = torch.cuda.get_device_properties(0).total_memory
    assert space.dense_budget_bytes == int(total * DENSE_MEMORY_SHARE)
    kind = device_kind()
    assert kind == device_kind(cuda_device) != "cpu"
    assert " " not in kind and kind == kind.lower()


def test_cuda_scheduler_keys_its_tuning_by_the_card(cuda_device,
                                                   monkeypatch, tmp_path):
    """A scheduler on the card looks its record up under
    ``cuda/<device kind>/v<bucket>`` and takes it; under the forced
    plain backend the key is ``torch/<device kind>/...``."""
    from repro_torch.api.options import MatchOptions
    from repro_torch.core.vectorized import WaveScheduler
    from repro_torch.data.graph_gen import er_labeled_graph
    from repro_torch.kernels.config import backend_scope
    from repro_torch.tuning import TuningCache, device_kind
    from repro_torch.tuning.space import CandidateConfig
    data = er_labeled_graph(40, 120, 3, seed=6)
    path = tmp_path / "cache.json"
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(path))
    monkeypatch.delenv("REPRO_TORCH_TUNING_DISABLE", raising=False)
    TuningCache(path).put("cuda", device_kind(cuda_device), data.n,
                          CandidateConfig(wave_size=32, n_slots=2,
                                          stack_capacity=256).as_params())
    sched = WaveScheduler(data, options=MatchOptions(limit=None),
                          device=cuda_device)
    rec = sched.tuning_record
    assert rec["source"] == "tuning-cache" and rec["backend"] == "cuda"
    assert rec["key"] == f"cuda/{device_kind(cuda_device)}/v64"
    assert sched.wave_size == 32 and sched.n_slots == 2
    with backend_scope("torch"):
        plain = WaveScheduler(data, options=MatchOptions(limit=None),
                              device=cuda_device)
    assert plain.tuning_record["source"] == "builtin"
    assert plain.tuning_record["key"].startswith("torch/")


# ---------------------------------------------------------------- models
def _f32_smoke(arch):
    import dataclasses
    from repro_torch.configs.registry import ARCHS
    return dataclasses.replace(ARCHS[arch].smoke_config,
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)


def _lm_outputs(model, cfg, tokens, targets):
    """lm_logits, lm_loss and 8 decode steps' logits, on the CPU."""
    from repro_torch.models import transformer as T
    with torch.no_grad():
        state = T.init_decode_state(cfg, 2, 8, device=tokens.device)
        steps = []
        for i in range(8):
            lg, state = T.lm_decode_step(model, cfg, tokens[:, i:i + 1],
                                         state)
            steps.append(lg[:, 0])
        return [t.cpu() for t in (
            T.lm_logits(model, cfg, tokens),
            T.lm_loss(model, cfg, {"tokens": tokens, "targets": targets}),
            torch.stack(steps, 1))]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b"])
def test_cuda_lm_smoke_equals_the_cpu(cuda_device, arch):
    """One set of float32 weights, drawn on the CPU and copied to the
    card: logits, loss (MTP included for DeepSeek) and 8 decode steps on
    the card equal the CPU's within the port's f32 rule (rtol 1e-4,
    atol 1e-5; TF32 off)."""
    import copy
    from repro_torch.models import transformer as T
    cfg = _f32_smoke(arch)
    cpu_model = T.lm_init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    card_model = copy.deepcopy(cpu_model).to(cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 17)))
    want = _lm_outputs(cpu_model, cfg, toks[:, :-1], toks[:, 1:])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = _lm_outputs(card_model, cfg, toks[:, :-1].to(cuda_device),
                          toks[:, 1:].to(cuda_device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_cuda_model_init_draws_on_the_generator_device(cuda_device):
    """A card generator draws on the card; a CPU generator's draws are
    placed on the card: both give card parameters, the CPU one the same
    values as on the CPU."""
    from repro_torch.models import transformer as T
    cfg = _f32_smoke("qwen3-0.6b")
    on_card = T.lm_init(torch.Generator(device=cuda_device).manual_seed(0),
                        cfg, device=cuda_device)
    from_cpu = T.lm_init(torch.Generator().manual_seed(0), cfg,
                         device=cuda_device)
    cpu = T.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(p.is_cuda for p in on_card.parameters())
    for a, b in zip(from_cpu.parameters(), cpu.parameters()):
        assert a.is_cuda and torch.equal(a.cpu(), b)
