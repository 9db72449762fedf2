"""The order-freedom the redesigned kernels rely on, on the CPU (numpy).

K7 (dense paged prefill attention) computes every dot product and sum in
float64 and rounds it once to float32, as its plain version does on the
card; its redesign sums in another order (f64 tensor-core MMAs over
4-wide k steps, keys split across the warps of a block and the blocks of
a cluster). The W4Ax GEMMs (K3, K4, K5) split a 128-deep block's integer
dot across MMA k steps and warps. This file checks, on seeded inputs at
Llama-3 widths, that those orders give the same float32 (the integer
case: the same int32) as the plain order:

* q·k scores: bf16-valued queries × dequantized int4 keys ((n − z)·s in
  f32), D = 128 — sequential, pairwise, and in chunks of 4, 8 and 16
  whose partials are added in turn;
* Σe and Σp·v over a row's keys: sequential, in key-split blocks (8
  cluster blocks × 4 warps), and in 4-key MMA steps;
* int32 block dots of int4/int8 codes split over k steps and warps.

What it proves: for these inputs the f64 summation error never reaches
an f32 rounding boundary, so each order rounds to the same f32; products
of two f32 are exact in f64 (checked). What only the card can show: the
order the hardware's DMMA and reductions actually take (its internal
accumulation within one MMA is not specified), and that the kernel is
bit-equal to its plain version there (``tests/test_torch_card.py``,
``chip_smoke.py``). Also here: :func:`dense_plan`, the host-side launch
plan of K7 and K6 (C = 1), against a direct computation from its rules.
"""
import math
from fractions import Fraction

import numpy as np
import pytest

from repro_torch.kernels import kv4_attention as KA

D = 128


def _f32(x):
    return np.asarray(x, np.float32)


def _bf16_valued(rng, shape, scale=1.0):
    """f32 values that a bf16 holds exactly (the engine's queries)."""
    x = _f32(rng.normal(size=shape) * scale)
    return (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def _dequant(rng, shape):
    """(n − z)·s in f32, as the plain version dequantizes int4 KV."""
    n = _f32(rng.integers(0, 16, shape))
    z = _f32(rng.uniform(6, 9, shape[-1]))
    s = _f32(rng.uniform(0.05, 0.2, shape[-1]))
    return _f32(_f32(n - z) * s)


def _seq(prod, axis=-1):
    """f64 sum in the plain, left-to-right order."""
    return np.cumsum(prod, axis=axis, dtype=np.float64).take(-1, axis=axis)


def _chunked(prod, chunk, axis=-1):
    """f64 sum of consecutive chunks, the chunks' partials added in turn
    (an MMA's k step added to its accumulator)."""
    prod = np.moveaxis(prod, axis, -1)
    k = prod.shape[-1]
    pad = (-k) % chunk
    prod = np.concatenate([prod, np.zeros(prod.shape[:-1] + (pad,))], -1)
    parts = prod.reshape(prod.shape[:-1] + (-1, chunk)).sum(-1)
    return _seq(parts)


def _split(prod, blocks, axis=-1):
    """f64 sum over ``blocks`` contiguous key ranges (cluster blocks ×
    warps), each summed on its own, the partials added in turn."""
    prod = np.moveaxis(prod, axis, -1)
    parts = [p.sum(-1) for p in np.array_split(prod, blocks, axis=-1)]
    return _seq(np.stack(parts, -1))


def _same_f32(*sums):
    first = _f32(sums[0])
    for s in sums[1:]:
        np.testing.assert_array_equal(_f32(s), first)


def test_f32_products_are_exact_in_f64():
    rng = np.random.default_rng(0)
    a, b = _bf16_valued(rng, 2000, 3.0), _dequant(rng, (2000,))
    p = a.astype(np.float64) * b.astype(np.float64)
    # exact: two 24-bit significands make at most 48 bits, inside f64's 53
    assert all(Fraction(float(x)) * Fraction(float(y)) == Fraction(float(z))
               for x, y, z in zip(a, b, p))


@pytest.mark.parametrize("seed", range(4))
def test_scores_round_alike_in_every_order(seed):
    """q·k over D = 128 for 512 queries × 256 keys of one head: the f32
    of the f64 dot is the same in the plain order, pairwise, and in
    k-chunks of 4 (m8n8k4 DMMA), 8 and 16."""
    rng = np.random.default_rng(seed)
    q = _bf16_valued(rng, (512, 1, D), 2.0)
    k = _dequant(rng, (1, 256, D))
    prod = q.astype(np.float64) * k.astype(np.float64)     # [512, 256, D]
    _same_f32(_seq(prod), prod.sum(-1), _chunked(prod, 4),
              _chunked(prod, 8), _chunked(prod, 16))


def _softmax_parts(rng, rows, keys, masked=0.0):
    s = _f32(rng.normal(size=(rows, keys)) * 3)
    if masked:
        s = np.where(rng.random((rows, keys)) < masked, _f32(-1e30), s)
        s[:, 0] = 1.0                        # every row has a valid key
    m = s.max(-1, keepdims=True)
    e = _f32(np.exp((s - m).astype(np.float64)))
    return e


@pytest.mark.parametrize("keys", [1, 63, 64, 65, 488, 4096])
def test_exp_sums_round_alike_when_split(keys):
    """Σe over a row's keys: plain order, 8 cluster blocks, 8 × 4 warp
    partials, 32-lane strided partials."""
    rng = np.random.default_rng(keys)
    e = _softmax_parts(rng, 256, keys, masked=0.3)
    ed = e.astype(np.float64)
    lanes = _seq(np.stack([ed[:, i::32].sum(-1) for i in range(32)], -1))
    _same_f32(_seq(ed), _split(ed, 8), _split(ed, 32), lanes)


@pytest.mark.parametrize("keys", [1, 65, 488, 1024])
def test_pv_sums_round_alike_when_split(keys):
    """Σ p·v over a row's keys with p = e / L in f32 and dequantized
    values: plain order, key-split blocks, and 4-key MMA steps."""
    rng = np.random.default_rng(100 + keys)
    e = _softmax_parts(rng, 64, keys, masked=0.2)
    l = _f32(e.astype(np.float64).sum(-1, keepdims=True))
    p = _f32(e / l)
    v = _dequant(rng, (keys, D))
    prod = (p.astype(np.float64)[:, :, None]
            * v.astype(np.float64)[None])                  # [64, keys, D]
    _same_f32(_seq(prod, 1), _split(prod, 8, 1), _split(prod, 32, 1),
              _chunked(prod, 4, 1))


def test_int32_block_dots_split_over_warps():
    """A 128-deep block dot of int4 × int8 codes is the same integer
    whether summed whole, over four 32-deep MMA k steps, or over warps
    taking whole blocks in turn (integer sums are exact)."""
    rng = np.random.default_rng(7)
    a = rng.integers(-128, 128, (16, 8 * 128)).astype(np.int32)
    w = rng.integers(0, 16, (8 * 128, 64)).astype(np.int32)
    for b in range(8):
        sl = slice(128 * b, 128 * b + 128)
        whole = a[:, sl] @ w[sl]
        steps = sum(a[:, sl][:, i:i + 32] @ w[sl][i:i + 32]
                    for i in range(0, 128, 32))
        # low nibbles first (k < 64), then high: the kernel's order
        halves = (a[:, sl][:, :64] @ w[sl][:64]
                  + a[:, sl][:, 64:] @ w[sl][64:])
        np.testing.assert_array_equal(whole, steps)
        np.testing.assert_array_equal(whole, halves)
        assert np.abs(whole).max() < 2 ** 31


def _direct_plan(b, c, g, hkv, np_, ps):
    """dense_plan's rules written out by enumeration."""
    cg = c * g
    rows = min(next(r for r in (8, 16, 32, 10 ** 9) if cg <= r), 32)
    blocks = b * hkv * math.ceil(cg / rows)
    tmax = np_ * ps + c
    kt = KA.DENSE_KEY_TILE

    def stride(s):
        per = 8 * math.ceil(math.ceil(tmax / s) / 8)
        return 32 * math.ceil(kt * math.ceil(per / kt) / 32) + 8

    def smem(s):
        return KA.DENSE_FIXED_SMEM + rows * stride(s) * 4

    def one_wave(s):
        per_sm = min({8: 4, 16: 2, 32: 1}[rows],
                     233472 // (min(smem(s), 232448) + 1024))
        return blocks * s <= 132 * per_sm

    fitting = [s for s in range(1, 9) if smem(s) <= 232448]
    least = fitting[0] if fitting else 8
    # the widest split from there on whose every step still runs in one
    # wave and keeps a key tile per block
    split = least
    for s in range(least + 1, min(8, math.ceil(tmax / kt)) + 1):
        if not one_wave(s):
            break
        split = s
    return rows, split, stride(split), smem(split) <= 232448, blocks


@pytest.mark.parametrize("shape", [
    (8, 1, 4, 8, 8, 64),        # decode, Llama-3-8B
    (8, 256, 4, 8, 8, 64),      # a 256-token chunk
    (1, 1, 4, 2, 1, 16),        # one tiny row
    (3, 4, 4, 2, 4, 16),        # C·G = 16
    (2, 9, 4, 2, 5, 16),        # C·G = 36: two 32-row tiles
    (1, 1, 4, 2, 800, 64),      # scores past shared memory at C = 1
    (2, 8, 4, 2, 95, 128),      # … and at 32 rows
    (64, 256, 4, 8, 64, 64),    # many blocks, long history
    (8, 1, 1, 8, 8, 64),        # K6 (dense decode), G = 1, 2, 8
    (8, 1, 2, 8, 8, 64),
    (8, 1, 8, 8, 8, 64),
    (6, 1, 4, 2, 96, 64),       # K6 with a 6,000-key row
])
def test_dense_plan_matches_direct_computation(shape):
    plan = KA.dense_plan(*shape)
    rows, split, stride, fits, blocks = _direct_plan(*shape)
    assert (plan.rows, plan.split, plan.sstride) == (rows, split, stride)
    fixed = KA.DENSE_FIXED_SMEM
    if fits:
        assert plan.scratch == 0
        assert plan.smem == fixed + rows * stride * 4 <= 232448
    else:
        assert plan.smem == fixed
        assert plan.scratch == blocks * split * rows * stride
    # the kernel's largest block share of keys (any nk ≤ NP·ps + C),
    # rounded to its key tiles, fits in a score row
    tmax = shape[4] * shape[5] + shape[1]
    per = 8 * math.ceil(math.ceil(tmax / split) / 8)
    kt = KA.DENSE_KEY_TILE
    assert kt * math.ceil(per / kt) <= stride - 8
    assert stride % 32 == 8 and 1 <= split <= 8
