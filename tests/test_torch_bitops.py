"""The port's int32 bit operations (``repro_torch.kernels.bitops``)
against numpy's uint32 arithmetic, edge words included (0, -1, INT_MIN,
single high bits). Integer results: every comparison is exact."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bitops

torch.set_num_threads(1)

EDGE = np.array([0, -1, -2**31, 2**31 - 1, 1, 2, 0x40000000, -2,
                 0x55555555, -0x55555556], np.int32)


def _words(seed, n=2000):
    rng = np.random.default_rng(seed)
    w = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return np.concatenate([EDGE, w])


def _popcount_np(x):
    u = x.view(np.uint32)
    return np.array([bin(int(v)).count("1") for v in u], np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_popcount(seed):
    x = _words(seed)
    got = bitops.popcount(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _popcount_np(x))
    rows = x[:2000].reshape(40, 50)
    np.testing.assert_array_equal(
        bitops.popcount_rows(torch.from_numpy(rows)).numpy(),
        _popcount_np(rows.reshape(-1)).reshape(40, 50).sum(1))


@pytest.mark.parametrize("k", [0, 1, 13, 15, 31])
def test_logical_right_shift(k):
    x = _words(2)
    got = bitops.lshr(torch.from_numpy(x), k).numpy()
    want = (x.view(np.uint32) >> np.uint32(k)).view(np.int32)
    np.testing.assert_array_equal(got, want)


def test_lowest_bit_and_index():
    x = _words(3)
    low = bitops.lowest_bit(torch.from_numpy(x))
    u = x.view(np.uint32).astype(np.uint64)
    want = (u & ((~u + np.uint64(1)) & np.uint64(0xFFFFFFFF))).astype(
        np.uint32).view(np.int32)
    np.testing.assert_array_equal(low.numpy(), want)
    idx = bitops.bit_index(low).numpy()
    nz = x != 0
    np.testing.assert_array_equal(
        idx[nz], np.log2(want[nz].view(np.uint32)).astype(np.int32))
    assert (idx[~nz] == 32).all()
    # bit 31 alone: -x overflows int32, the helper must not
    assert int(bitops.bit_index(bitops.lowest_bit(
        torch.tensor([-2**31], dtype=torch.int32)))[0]) == 31


def test_bitlen32():
    x = _words(4)
    got = bitops.bitlen32(torch.from_numpy(x)).numpy()
    want = np.array([int(v).bit_length() for v in x.view(np.uint32)],
                    np.int32)
    np.testing.assert_array_equal(got, want)


def test_mul32_and_casts_wrap_like_uint32():
    x = _words(5)
    u = bitops.u32(torch.from_numpy(x))
    np.testing.assert_array_equal(u.numpy(),
                                  x.view(np.uint32).astype(np.int64))
    np.testing.assert_array_equal(bitops.to_i32(u).numpy(), x)
    for m in (2654435761, 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35):
        got = bitops.mul32(u, m).numpy()
        with np.errstate(over="ignore"):
            want = (x.view(np.uint32) * np.uint32(m)).astype(np.int64)
        np.testing.assert_array_equal(got, want)


def test_bit_table():
    t = bitops.bit_table("cpu").numpy()
    np.testing.assert_array_equal(
        t.view(np.uint32), (np.uint32(1) << np.arange(32, dtype=np.uint32)))
