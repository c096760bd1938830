"""The three CUDA routes of the port's attention kernel, on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
Here the arithmetic each route does is held against the JAX package's
Pallas kernel (``repro.kernels.flash_attention.flash_attention`` in
interpret mode) and against the port's plain version, on the same numpy
inputs made from a seed:

  * ``split`` — ``ref.flash_attention_split_ref``: per-split partials
    ``(m, l, acc)`` and their combine, in f32, within the reference's
    2e-4;
  * ``tc`` — ``ref.flash_attention_tc_ref``: 64-key tiles, the softmax
    weights rounded to bf16 before P·V, within the bf16 rule of the card
    tests (rtol 2e-2, atol two bf16 units of each output row's largest
    value);

and ``flash_attention.plan``, which picks the route from shape and dtype
alone, is pinned case by case.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention import (SPLIT_BLOCKS_PER_SM,
                                                 SPLIT_MIN_KEYS, plan)
from repro_torch.kernels.ref import (flash_attention_ref,
                                     flash_attention_split_ref,
                                     flash_attention_tc_ref,
                                     flash_split_partials)

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16


def _qkv(b, h, hkv, s, skv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def _pallas(arrays, causal, dtype):
    """The reference's Pallas kernel in interpret mode, as f32 numpy."""
    q, k, v = (jnp.asarray(a, dtype) for a in arrays)
    out = pallas_flash(q, k, v, causal=causal, block_q=q.shape[2],
                       block_k=math.gcd(k.shape[2], 128), interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _bf16_close(got, want):
    """The bf16 rule: rtol 2e-2 plus two bf16 units of each row's
    largest |want|."""
    got, want = (torch.as_tensor(np.array(a, np.float32)) for a in
                 (got, want))
    atol = 2 * 2.0 ** -8 * want.abs().amax(-1, keepdim=True)
    bad = (got - want).abs() > atol + 2e-2 * want.abs()
    assert not bool(bad.any()), float((got - want).abs().max())


# ---------------------------------------------------------------- split
SPLIT_CASES = [
    # b, h, hkv, s, skv, split_len, causal
    (1, 1, 1, 1, 256, 256, False),     # one split, group 1
    (2, 4, 2, 3, 512, 256, False),     # two splits, group 2
    (1, 8, 1, 8, 704, 256, False),     # three, the last ragged; group 8
    (1, 2, 1, 5, 512, 64, False),      # eight splits
    (1, 8, 1, 4, 512, 64, True),       # causal S < Skv: 7 splits masked
    (2, 2, 2, 8, 300, 128, True),      # ragged and causal
    (1, 16, 8, 1, 1024, 256, True),    # the decode geometry, causal
    (1, 2, 2, 2, 640, 256, False),     # ragged third split, S 2
]


@pytest.mark.parametrize("b,h,hkv,s,skv,split_len,causal", SPLIT_CASES)
def test_split_emulation_matches_pallas_and_plain(b, h, hkv, s, skv,
                                                  split_len, causal):
    arrays = _qkv(b, h, hkv, s, skv, 64, b + h + s + skv)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = flash_attention_split_ref(q, k, v, causal, split_len)
    assert got.dtype == F32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), _pallas(arrays, causal,
                                                     jnp.float32),
                               rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, causal),
                               rtol=2e-4, atol=2e-4)


def test_split_partials_past_the_diagonal_are_neutral():
    """Causal S 4 against 512 keys in splits of 64: every split but the
    first is wholly past every row's position and carries (-1e30, 0, 0)
    exactly, so it weighs nothing in the combine."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 1, 4, 512, 32, 3))
    m, l, acc = flash_split_partials(q, k, v, True, 64)
    assert m.shape == (1, 1, 8, 32) and acc.shape == (1, 1, 8, 32, 32)
    assert bool((m[:, :, 1:] == -1e30).all())
    assert bool((l[:, :, 1:] == 0).all()) and bool((acc[:, :, 1:] == 0).all())
    assert bool((l[:, :, 0] >= 1).all())


@pytest.mark.parametrize("split_len", [64, 128, 192, 320])
def test_split_emulation_bf16_matches_plain(split_len):
    """bf16 in and out: the split partials are f32, so the combine
    rounds once, as the plain version does."""
    q, k, v = (torch.from_numpy(a).to(BF16)
               for a in _qkv(2, 4, 1, 2, 400, 128, split_len))
    got = flash_attention_split_ref(q, k, v, False, split_len)
    assert got.dtype == BF16
    _bf16_close(got.float(), flash_attention_ref(q, k, v, False).float())


# ---------------------------------------------------------------- tc
TC_CASES = [
    # b, h, hkv, s, skv, d, causal
    (1, 2, 2, 128, 128, 64, True),
    (1, 4, 2, 64, 256, 128, True),     # causal S < Skv
    (1, 2, 1, 192, 64, 32, True),      # causal S > Skv
    (1, 2, 2, 100, 100, 48, False),    # ragged S and Skv tiles
    (2, 4, 4, 64, 192, 16, False),
]


@pytest.mark.parametrize("b,h,hkv,s,skv,d,causal", TC_CASES)
def test_tc_emulation_matches_pallas_and_plain(b, h, hkv, s, skv, d,
                                               causal):
    arrays = _qkv(b, h, hkv, s, skv, d, s + skv + d)
    q, k, v = (torch.from_numpy(a).to(BF16) for a in arrays)
    got = flash_attention_tc_ref(q, k, v, causal)
    assert got.dtype == BF16 and got.shape == q.shape
    _bf16_close(got.float(), _pallas(arrays, causal, jnp.bfloat16))
    _bf16_close(got.float(), flash_attention_ref(q, k, v, causal).float())


def test_tc_emulation_rounds_p_to_bf16():
    """In f32 the only rounding left is P's: the emulation sits a bf16
    rounding of the weights away from the exact result — far past f32
    noise, well inside the bf16 rule."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 64, 64, 64, 5))
    got = flash_attention_tc_ref(q, k, v, True)
    want = flash_attention_ref(q, k, v, True)
    err = float((got - want).abs().max())
    assert 1e-5 < err < 2e-2
    _bf16_close(got, want)


# ---------------------------------------------------------------- plan
def _splits(p, s_kv):
    return [(i * p.split_len, min((i + 1) * p.split_len, s_kv))
            for i in range(p.n_splits)]


@pytest.mark.parametrize("b,h,hkv,s,skv", [
    (4, 16, 8, 1, 32768), (1, 16, 8, 1, 32768), (1, 4, 2, 1, 300),
    (1, 8, 1, 8, 32768), (2, 2, 2, 8, 100), (128, 16, 8, 1, 4096),
    (1, 1, 1, 1, 1), (3, 6, 3, 5, 1000)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plan_splits_cover_every_key_once(b, h, hkv, s, skv, dtype):
    p = plan((b, h, s, 128), (b, hkv, skv, 128), dtype)
    assert p.route == "split" and p.rows == (h // hkv) * s
    # a power of two of at least 256 keys: a multiple of every key tile
    assert p.split_len >= SPLIT_MIN_KEYS and p.split_len % 256 == 0
    assert p.split_len & (p.split_len - 1) == 0
    assert (b * hkv * p.n_splits <= SPLIT_BLOCKS_PER_SM * 132
            or p.n_splits == 1)
    spans = _splits(p, skv)
    assert spans[0][0] == 0 and spans[-1][1] == skv
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plan_fills_the_card_at_decode(dtype):
    """The smoke's decode step (B 4, Hkv 8, Skv 32768) reaches at least
    two blocks per SM on 132 SMs and at most four (one resident wave),
    and so does a batch of one."""
    for b in (4, 1):
        p = plan((b, 16, 1, 128), (b, 8, 32768, 128), dtype, n_sm=132)
        assert p.route == "split"
        assert 2 * 132 <= b * 8 * p.n_splits <= 4 * 132


@pytest.mark.parametrize("q_shape,kv_shape,dtype,route", [
    ((1, 16, 4096, 128), (1, 8, 4096, 128), BF16, "tc"),     # prefill
    ((1, 16, 4096, 128), (1, 8, 4096, 128), F32, "fma"),     # f32 prefill
    ((1, 2, 33, 129), (1, 2, 33, 129), BF16, "fma"),         # D 129
    ((4, 16, 1, 129), (4, 8, 300, 129), BF16, "fma"),        # decode, D 129
    ((4, 16, 1, 129), (4, 8, 300, 129), F32, "fma"),
    ((1, 8, 8, 64), (1, 1, 512, 64), BF16, "split"),         # 64 rows
    ((1, 8, 9, 64), (1, 1, 512, 64), BF16, "tc"),            # 72 rows
    ((1, 8, 9, 64), (1, 1, 512, 64), F32, "fma"),
    ((1, 1, 1, 6), (1, 1, 64, 6), F32, "fma"),               # 24-byte rows
    ((1, 1, 1, 8), (1, 1, 64, 8), F32, "split"),             # 32-byte rows
    ((1, 1, 1, 8), (1, 1, 64, 8), BF16, "split"),            # 16-byte rows
    ((1, 2, 128, 24), (1, 2, 128, 24), BF16, "fma"),         # D % 16 != 0
    ((1, 2, 128, 256), (1, 2, 128, 256), BF16, "tc"),
])
def test_plan_routes(q_shape, kv_shape, dtype, route):
    assert plan(q_shape, kv_shape, dtype).route == route


# The card tests' cases of ``test_cuda_flash_kernel_matches_plain`` and
# the route each takes on the card.
CARD_CASES = {
    (1, 2, 2, 48, 48, 16): ("split", "split"),
    (2, 8, 1, 64, 80, 64): ("fma", "tc"),
    (1, 4, 4, 96, 32, 48): ("fma", "tc"),
    (1, 4, 2, 1, 300, 128): ("split", "split"),
    (1, 2, 1, 40, 100, 256): ("fma", "tc"),
    (1, 2, 2, 33, 33, 129): ("fma", "fma"),
}


@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_plan_routes_of_the_card_cases(case):
    b, h, hkv, s, skv, d = case
    got = tuple(plan((b, h, s, d), (b, hkv, skv, d), dt).route
                for dt in (F32, BF16))
    assert got == CARD_CASES[case]


def test_plan_raises_where_no_route_goes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        plan((1, 1, 1, 64), (1, 1, 64, 64), torch.float16)
    with pytest.raises(ValueError, match="256"):
        plan((1, 1, 1, 257), (1, 1, 64, 257), F32)


def test_cpu_calls_count_no_route():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 1, 300, 64, 9))
    before = dict(flash_attention.FLASH_ROUTES)
    launches = flash_attention.FLASH_LAUNCHES
    out = flash_attention.flash_attention(q, k, v, causal=False,
                                          block_k=300)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, False))
    assert flash_attention.FLASH_ROUTES == before
    assert flash_attention.FLASH_LAUNCHES == launches
