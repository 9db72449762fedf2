"""Each CUDA kernel of the port against its plain version, on the card.

Imports no JAX, so it runs where only PyTorch with CUDA is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

Small shapes; ``chip_smoke.py`` checks the Llama-3-8B widths. Skips where
``torch.cuda.is_available()`` is false.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import act_quant as AQ
from repro_torch.kernels import kv4_attention as KA
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import w4ax_matmul as WK
from repro_torch.serving.kv_cache import build_work_queue


# GQA groups: the powers of two, then Qwen2.5-32B's 5, StarCoder2-15B's 12
# and 3 and 16 (the decode kernels' 16-row tile, full and partial)
GROUPS = [1, 2, 4, 8, 3, 5, 12, 16]


def _cuda(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def _device_launches(fn, calls: int = 3, tries: int = 5) -> float:
    """Kernels one call of ``fn`` puts on the card, by ``torch.profiler``:
    ``calls`` calls traced between marker kernels (``torch.cuda._sleep``),
    two before and one after, counted on the trace's timeline between
    them. A profiling session of a process can miss the first kernel it
    should see (the first leading marker, after many earlier tests) or
    come back without the card's activity; a trace whose op kernels are
    not bracketed by markers is taken again, at most ``tries`` times, and
    never counted."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        marks = [("spin_kernel" in e.name) for e in sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        op = [i for i, m in enumerate(marks) if not m]
        if (len(marks) >= 2 and marks[0] and marks[-1]
                and not (op and any(marks[op[0]:op[-1] + 1]))):
            return len(op) / calls
    pytest.fail(f"torch.profiler lost the card's activity in {tries} traces")


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    x = torch.randn((16, 384), device="cuda")
    for bits, kern in ((4, AQ.act_quant_int4), (8, AQ.act_quant_int8)):
        got, want = kern(x), AQ.act_quant_ref(x, bits=bits)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    rng = np.random.default_rng(1)
    m, nb4, nb8, n = 16, 3, 1, 128
    a4 = _cuda(rng.integers(0, 256, (m, nb4 * 64)).astype(np.uint8))
    s4 = _cuda(rng.uniform(0.01, 0.2, (m, nb4)).astype(np.float32))
    a8 = _cuda(rng.integers(-128, 128, (m, nb8 * 128)).astype(np.int8))
    s8 = _cuda(rng.uniform(0.001, 0.02, (m, nb8)).astype(np.float32))
    w = _cuda(rng.integers(0, 256, ((nb4 + nb8) * 64, n)).astype(np.uint8))
    ws = _cuda(rng.uniform(0.001, 0.05, (nb4 + nb8, n)).astype(np.float32))
    got = WK.w4ax_matmul_split(a4, s4, a8, s8, w, ws)
    want = WK.w4ax_matmul_ref(a4, s4, a8, s8, w[:nb4 * 64], ws[:nb4],
                              w[nb4 * 64:], ws[nb4:])
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())

    # a decode row, a first chunk and a mid-prefill row, one qlen-0 pad row
    hq, hkv, d, ps, c, nb = 8, 2, 128, 16, 16, 4
    ctx, qls = [40, 0, 17], [1, 12, 5]
    need = [-(-(cx + ql) // ps) for cx, ql in zip(ctx, qls)]
    num_pages = sum(need) + 3
    tbl = np.full((len(ctx), max(need)), -1, np.int32)
    perm = rng.permutation(num_pages)
    i = 0
    for bi, npg in enumerate(need):
        tbl[bi, :npg] = perm[i:i + npg]
        i += npg
    pools = [rng.integers(0, 256, (num_pages, ps, hkv, d // 2)).astype(np.uint8)
             for _ in range(2)]
    stats = [rng.uniform(lo, hi, (hkv, 1, d)).astype(np.float32)
             for lo, hi in ((0.05, 0.2), (6, 9), (0.05, 0.2), (6, 9))]
    q, kn, vn = [rng.normal(size=(nb, c, h, d)).astype(np.float32)
                 for h in (hq, hkv, hkv)]
    desc = build_work_queue(tbl, ctx, ps, hkv, qls, pad_row=nb * hkv)
    args = [_cuda(a) for a in (q, kn, vn, pools[0], stats[0], stats[1],
                               pools[1], stats[2], stats[3], desc)]
    got = PA.paged_kv4_prefill_attention_wq(*args)
    want = PA.paged_kv4_prefill_attention_wq_ref(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for bi, ql in enumerate(qls):                # the valid rows, exactly
        assert torch.equal(got[bi, :ql], want[bi, :ql]), (
            bi, float((got[bi, :ql] - want[bi, :ql]).abs().max()))


# (K, k4): the test model's 1,024 (7 + 1 blocks), Llama-3-8B's q/k/v, wo,
# up/gate and down projections at int4_fraction 0.875, and the other
# dense configurations' d_model and d_ff (5,120, 6,144, 8,192; 24,576,
# 27,648, 28,672 and Qwen2-72B's 29,568: 231 blocks, an odd 202 + 29)
FUSED_K = ((1024, 896), (4096, 3584), (14336, 12544), (5120, 4480),
           (6144, 5376), (8192, 7168), (24576, 21504), (27648, 24192),
           (28672, 25088), (29568, 25856))


def _act_input(gen, m: int, k: int, k4: int, dtype):
    """Random activations with, in each range, a block whose scale is
    exactly 1 holding every odd multiple of 0.5 (rounding ties), and an
    all-zero block."""
    x = torch.randn((m, k), generator=gen, device="cuda") * 3
    tie = ((torch.arange(128, device="cuda") % 15) - 7) * 0.5
    for lo, qmax in ((0, 7.0), (k4, 127.0)):
        if lo < k:
            x[0, lo:lo + 128] = tie
            x[0, lo] = qmax
    x[-1, -128:] = 0.0
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("k,k4", FUSED_K)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_act_quant_exact_on_card(dtype, k, k4):
    """Both ranges in one launch, byte for byte its plain version, also
    with one range empty (k4 = 0: K2 alone; k4 = K: K1 alone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    gen = torch.Generator(device="cuda").manual_seed(k)
    for m in (1, 8, 257, 4096):
        x = _act_input(gen, m, k, k4, dtype)
        for split in (k4, 0, k):
            got = AQ.act_quant_w4ax(x, split)
            want = AQ.act_quant_w4ax_ref(x, split)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.shape == w.shape and torch.equal(g, w), (
                    m, split, int((g != w).sum()))


@pytest.mark.cuda
def test_fused_act_quant_views_and_launches_on_card():
    """A strided-row view is read where it lies; a base or row stride off
    16-byte alignment raises; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    gen = torch.Generator(device="cuda").manual_seed(7)
    buf = _act_input(gen, 33, 4096 + 256, 3584, torch.bfloat16)
    x = buf[:, 128:128 + 4096]               # row stride 4,352, offset 256 B
    assert x.stride(0) == 4096 + 256
    for got, want in zip(AQ.act_quant_w4ax(x, 3584),
                         AQ.act_quant_w4ax_ref(x, 3584)):
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="16-byte"):
        AQ.act_quant_w4ax(buf[:, 1:1 + 4096], 3584)        # base + 2 B
    with pytest.raises(ValueError, match="16-byte"):
        AQ.act_quant_w4ax(torch.zeros((4, 4100), dtype=torch.bfloat16,
                                      device="cuda")[:, :4096], 3584)
    assert _device_launches(lambda: AQ.act_quant_w4ax(x, 3584)) == 1


def _exact(got, want):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
def test_baseline_attention_kernels_match_plain_on_card():
    """K10 (contiguous), K6 (dense paged) and K8 (work-queue) decode and
    K7 (dense prefill) bit for bit against their f32 plain versions:
    ragged lengths that are not page multiples, −1 table entries, a ctx-0
    row beside rows with history, q_len-0 pad rows and count-0 pad
    items."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(2)
    hq, hkv, d, ps = 8, 2, 128, 16
    stats = [_cuda(rng.uniform(lo, hi, (hkv, 1, d)).astype(np.float32))
             for lo, hi in ((0.05, 0.2), (6, 9), (0.05, 0.2), (6, 9))]
    ks, kz, vs, vz = stats

    lens = np.array([70, 33, 1], np.int32)             # K10, T = 70
    kp, vp = [_cuda(rng.integers(0, 256, (3, hkv, 70, d // 2)).astype(np.uint8))
              for _ in range(2)]
    q = _cuda(rng.normal(size=(3, hq, d)).astype(np.float32))
    bc = [s.expand(3, hkv, 1, d) for s in stats]
    args = (q, kp, bc[0], bc[1], vp, bc[2], bc[3], _cuda(lens))
    _exact(KA.kv4_decode_attention(*args), KA.kv4_decode_attention_ref(*args))

    lens = [40, 17, 1]                                 # K6, K8
    need = [-(-n // ps) for n in lens]
    num_pages = sum(need) + 3
    tbl = np.full((3, max(need) + 1), -1, np.int32)
    perm = rng.permutation(num_pages)
    i = 0
    for bi, n in enumerate(need):
        tbl[bi, :n] = perm[i:i + n]
        i += n
    pools = [_cuda(rng.integers(0, 256, (num_pages, ps, hkv, d // 2))
                   .astype(np.uint8)) for _ in range(2)]
    args = (q, pools[0], ks, kz, pools[1], vs, vz, _cuda(tbl),
            _cuda(np.asarray(lens, np.int32)))
    _exact(PA.paged_kv4_decode_attention(*args),
           PA.paged_kv4_decode_attention_ref(*args))
    desc = _cuda(build_work_queue(tbl, lens, ps, hkv))
    args = (q, pools[0], ks, kz, pools[1], vs, vz, desc)
    _exact(PA.paged_kv4_decode_attention_wq(*args),
           PA.paged_kv4_decode_attention_wq_ref(*args))

    ctx, qls, c = [40, 0, 17, 0], [1, 12, 5, 0], 16    # K7, one pad row
    qc, kn, vn = [_cuda(rng.normal(size=(4, c, h, d)).astype(np.float32))
                  for h in (hq, hkv, hkv)]
    t4 = np.zeros((4, tbl.shape[1]), np.int32)
    t4[:3] = tbl
    args = (qc, kn, vn, pools[0], ks, kz, pools[1], vs, vz, _cuda(t4),
            _cuda(np.asarray(ctx, np.int32)), _cuda(np.asarray(qls, np.int32)))
    got = PA.paged_kv4_prefill_attention(*args)
    want = PA.paged_kv4_prefill_attention_ref(*args)
    assert torch.isfinite(got).all()
    for bi, ql in enumerate(qls):
        if ql:
            _exact(got[bi, :ql], want[bi, :ql])


@pytest.mark.cuda
def test_mixed_gemm_kernel_matches_plain_on_card():
    """K5 against its plain version bit for bit: mixed shapes with ragged
    M and N tiles, and the degenerate ones that fall back to K3 or K4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(3)
    for m, nb4, nb8, n in ((1, 7, 1, 128), (16, 3, 2, 68), (70, 14, 2, 200),
                           (5, 0, 2, 64), (9, 2, 0, 64)):
        a4 = _cuda(rng.integers(0, 256, (m, nb4 * 64)).astype(np.uint8))
        s4 = _cuda(rng.uniform(0.01, 0.2, (m, nb4)).astype(np.float32))
        a8 = _cuda(rng.integers(-128, 128, (m, nb8 * 128)).astype(np.int8))
        s8 = _cuda(rng.uniform(0.001, 0.02, (m, nb8)).astype(np.float32))
        w = _cuda(rng.integers(0, 256, ((nb4 + nb8) * 64, n)).astype(np.uint8))
        ws = _cuda(rng.uniform(0.001, 0.05, (nb4 + nb8, n)).astype(np.float32))
        before = (WK.w4ax_matmul_mixed.launches, WK.w4a4_matmul.launches,
                  WK.w4a8_matmul.launches)
        got = WK.w4ax_matmul_mixed(a4, s4, a8, s8, w, ws)
        want = WK.w4ax_matmul_mixed_ref(a4, s4, a8, s8, w, ws)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (m, nb4, nb8, n,
                                        float((got - want).abs().max()))
        after = (WK.w4ax_matmul_mixed.launches, WK.w4a4_matmul.launches,
                 WK.w4a8_matmul.launches)
        which = 2 if nb4 == 0 else 1 if nb8 == 0 else 0
        assert [a - b for a, b in zip(after, before)] == [
            int(i == which) for i in range(3)]


def _gemm_operands(rng, m, nb4, nb8, n):
    return (_cuda(rng.integers(0, 256, (m, nb4 * 64)).astype(np.uint8)),
            _cuda(rng.uniform(0.01, 0.2, (m, nb4)).astype(np.float32)),
            _cuda(rng.integers(-128, 128, (m, nb8 * 128)).astype(np.int8)),
            _cuda(rng.uniform(0.001, 0.02, (m, nb8)).astype(np.float32)),
            _cuda(rng.integers(0, 256, ((nb4 + nb8) * 64, n))
                  .astype(np.uint8)),
            _cuda(rng.uniform(0.001, 0.05, (nb4 + nb8, n))
                  .astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [68, 200, 1024, 4096])
def test_w4ax_tiles_match_plain_exactly_on_card(n):
    """K3, K4 (both conversions) and K5 bit for bit against their plain
    versions on both tiles — the decode tile (M ≤ 16) and the prefill
    tile — and across their edges: M ∈ {1, 8, 15, 16, 17, 63, 64, 65,
    256}, N not a multiple of 16 (4-byte copies) or of the tile width,
    K block counts that are not multiples of the decode kernel's group
    of 4 or the ring's depth."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(n)
    for m in (1, 8, 15, 16, 17, 63, 64, 65, 256):
        nb4, nb8 = int(rng.integers(1, 8)), int(rng.integers(1, 4))
        a4, s4, a8, s8, w, ws = _gemm_operands(rng, m, nb4, nb8, n)
        w4, ws4 = w[:nb4 * 64], ws[:nb4]
        w8, ws8 = w[nb4 * 64:], ws[nb4:]
        for conv in ("zeroext", "signext"):
            got = WK.w4a4_matmul(a4, s4, w4, ws4, conversion=conv)
            assert torch.equal(got, WK.w4a4_matmul_ref(a4, s4, w4, ws4)), (
                "w4a4", conv, m, n, nb4)
            got = WK.w4a8_matmul(a8, s8, w8, ws8, conversion=conv)
            assert torch.equal(got, WK.w4a8_matmul_ref(a8, s8, w8, ws8)), (
                "w4a8", conv, m, n, nb8)
        got = WK.w4ax_matmul_mixed(a4, s4, a8, s8, w, ws)
        want = WK.w4ax_matmul_mixed_ref(a4, s4, a8, s8, w, ws)
        torch.cuda.synchronize()
        assert torch.equal(got, want), ("mixed", m, n, nb4, nb8)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(28672, 8192), (8192, 28672),
                                 (8192, 29568)])
def test_w4ax_archs_shapes_exact_on_card(n, k):
    """K3 and K4 bit for bit at the new configurations' widest
    projections — Llama-3-70B's up/gate (N 28,672, K 8,192) and down
    (K 28,672), Qwen2-72B's down (K 29,568: 202 int4 blocks and an odd 29
    int8 blocks) — at M = 8 (decode tile) and 256 (prefill tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(n + k)
    nb = k // 128
    nb4 = int(round(0.875 * nb))
    for m in (8, 256):
        a4, s4, a8, s8, w, ws = _gemm_operands(rng, m, nb4, nb - nb4, n)
        w4, ws4 = w[:nb4 * 64], ws[:nb4]
        w8, ws8 = w[nb4 * 64:], ws[nb4:]
        got = WK.w4a4_matmul(a4, s4, w4, ws4)
        assert torch.equal(got, WK.w4a4_matmul_ref(a4, s4, w4, ws4)), (
            "w4a4", m)
        got = WK.w4a8_matmul(a8, s8, w8, ws8)
        torch.cuda.synchronize()
        assert torch.equal(got, WK.w4a8_matmul_ref(a8, s8, w8, ws8)), (
            "w4a8", m)


def _dense_case(rng, ctx, qls, c, hq, hkv, ps, extra_pages=2, d=128):
    """K7 inputs: one row per (history, q_len), its pages scattered over
    the pool, −1 past each row's pages; f32 query and chunk."""
    need = [max(1, -(-(cx + ql) // ps)) for cx, ql in zip(ctx, qls)]
    num_pages = sum(need) + extra_pages
    tbl = np.full((len(ctx), max(need) + 1), -1, np.int32)
    perm = rng.permutation(num_pages)
    i = 0
    for bi, npg in enumerate(need):
        tbl[bi, :npg] = perm[i:i + npg]
        i += npg
    pools = [_cuda(rng.integers(0, 256, (num_pages, ps, hkv, d // 2))
                   .astype(np.uint8)) for _ in range(2)]
    ks, kz, vs, vz = [_cuda(rng.uniform(lo, hi, (hkv, 1, d))
                            .astype(np.float32))
                      for lo, hi in ((0.05, 0.2), (6, 9), (0.05, 0.2),
                                     (6, 9))]
    b = len(ctx)
    q, kn, vn = [_cuda(rng.normal(size=(b, c, h, d)).astype(np.float32))
                 for h in (hq, hkv, hkv)]
    return (q, kn, vn, pools[0], ks, kz, pools[1], vs, vz, _cuda(tbl),
            _cuda(np.asarray(ctx, np.int32)), _cuda(np.asarray(qls, np.int32)))


def _dense_exact(args, qls):
    got = PA.paged_kv4_prefill_attention(*args)
    want = PA.paged_kv4_prefill_attention_ref(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    g = args[0].shape[2] // args[3].shape[2]
    for bi, ql in enumerate(qls):
        assert torch.equal(got[bi, :ql], want[bi, :ql]), (
            bi, ql, float((got[bi, :ql] - want[bi, :ql]).abs().max()))
        assert not got[bi, ql:].any()        # rows past q_len: zeros
    return g


@pytest.mark.cuda
def test_dense_prefill_decode_shape_exact_on_card():
    """K7 at C = 1, G = 4 bit for bit against its plain version across the
    cluster split's edges: contexts of 1, ps−1, ps, ps+1 and 487 keys,
    and one whose scores exceed the shared-memory buffer (the scratch
    path, checked through :func:`dense_plan`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(5)
    hq, hkv, ps = 8, 2, 64
    ctx = [1, ps - 1, ps, ps + 1, 487]
    args = _dense_case(rng, ctx, [1] * len(ctx), 1, hq, hkv, ps)
    assert KA.dense_plan(len(ctx), 1, 4, hkv, args[9].shape[1], ps).split > 1
    _dense_exact(args, [1] * len(ctx))

    big = [50_000, 3]
    args = _dense_case(rng, big, [1, 1], 1, hq, hkv, ps)
    plan = KA.dense_plan(2, 1, 4, hkv, args[9].shape[1], ps)
    assert plan.scratch > 0 and plan.split == 8, plan
    _dense_exact(args, [1, 1])


@pytest.mark.cuda
def test_dense_prefill_tiles_exact_on_card():
    """K7 bit for bit on its 16- and 32-row tiles: chunks of several
    queries with history, a first chunk (no history), pad rows past
    q_len, q_len-0 rows with and without history, and a chunk whose
    scores go to scratch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(6)
    hq, hkv, ps = 8, 2, 16
    for c, ctx, qls in ((4, [40, 0, 17, 5], [4, 3, 1, 0]),
                        (16, [40, 0, 17, 0, 70], [16, 12, 5, 0, 9]),
                        (37, [130, 0, 33], [37, 20, 0])):
        args = _dense_case(rng, ctx, qls, c, hq, hkv, ps)
        _dense_exact(args, qls)
    ctx, qls = [12_000, 7], [8, 8]
    args = _dense_case(rng, ctx, qls, 8, hq, hkv, 128)
    plan = KA.dense_plan(2, 8, 4, hkv, args[9].shape[1], 128)
    assert plan.rows == 32 and plan.scratch > 0, plan
    _dense_exact(args, qls)


def _wq_case(rng, ctx, qls, c, hq, hkv, ps, nb, d=128):
    """K9 inputs: one row per (history, q_len) — its pages scattered over
    the pool — plus q_len-0 pad rows up to ``nb``; bf16-valued queries as
    the engine hands them over."""
    need = [max(1, -(-(cx + ql) // ps)) for cx, ql in zip(ctx, qls)]
    num_pages = sum(need) + 2
    tbl = np.full((len(ctx), max(need) + 1), -1, np.int32)
    perm = rng.permutation(num_pages)
    i = 0
    for bi, npg in enumerate(need):
        tbl[bi, :npg] = perm[i:i + npg]
        i += npg
    pools = [_cuda(rng.integers(0, 256, (num_pages, ps, hkv, d // 2))
                   .astype(np.uint8)) for _ in range(2)]
    ks, kz, vs, vz = [_cuda(rng.uniform(lo, hi, (hkv, 1, d))
                            .astype(np.float32))
                      for lo, hi in ((0.05, 0.2), (6, 9), (0.05, 0.2),
                                     (6, 9))]
    q = _cuda(rng.normal(size=(nb, c, hq, d)).astype(np.float32)
              ).bfloat16()
    kn, vn = [_cuda(rng.normal(size=(nb, c, hkv, d)).astype(np.float32) * 4)
              for _ in range(2)]
    desc = build_work_queue(tbl, ctx, ps, hkv, qls, pad_row=nb * hkv)
    return (q, kn, vn, pools[0], ks, kz, pools[1], vs, vz, _cuda(desc)), desc


def _wq_exact(args, desc, qls):
    b, c, hq, _ = args[0].shape
    hkv = args[3].shape[2]
    plan = PA.work_plan(desc, b * hkv, c, hq // hkv, "cuda")
    before = PA.paged_kv4_prefill_attention_wq.launches
    got = PA.paged_kv4_prefill_attention_wq(*args, plan=plan)
    assert PA.paged_kv4_prefill_attention_wq.launches == before + 1
    again = PA.paged_kv4_prefill_attention_wq(*args)   # plan from desc
    want = PA.paged_kv4_prefill_attention_wq_ref(*args, plan=plan)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)      # deterministic, whoever arrives last
    for bi, ql in enumerate(qls):
        assert torch.equal(got[bi, :ql], want[bi, :ql]), (
            bi, ql, float((got[bi, :ql] - want[bi, :ql]).abs().max()))
    for bi in range(len(qls), b):       # q_len-0 pad rows: zeros
        assert not got[bi].any()
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("c", [1, 4, 37, 256])
def test_wq_prefill_exact_on_card(c, ps):
    """K9 bit for bit against its plain version on the valid rows: a row
    with no history beside rows with history, a row with many page items
    (kmax ≥ 9), q_len-0 pad rows, the power-of-two pad items of the
    descriptor array, and chunks of C = 1 (decode), 4, 37 and 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(10 * c + ps)
    hq, hkv = 8, 2
    long_ctx = 10 * ps + 3                       # 11 page items
    if c == 1:
        ctx, qls = [40, long_ctx, 0, ps], [1, 1, 1, 1]
    else:
        ctx, qls = [0, long_ctx, 17, ps - 1], [c, max(1, c // 2), c, 1]
    args, desc = _wq_case(rng, ctx, qls, c, hq, hkv, ps, len(ctx) + 2)
    plan = _wq_exact(args, desc, qls)
    kmax = np.bincount(desc[desc[:, 2] > 0, 0]).max()
    assert kmax >= 9 and (desc[:, 2] == 0).any(), (kmax, desc.shape)
    assert plan.rows == (8 if c == 1 else 16 if c == 4 else 32)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 4, 256])
def test_wq_prefill_group12_exact_on_card(c):
    """K9 at StarCoder2-15B's GQA group (G = 12; C·G rows on 16- and
    32-row tiles, several tiles a row at C = 4 and 256) bit for bit on
    the valid rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(200 + c)
    hq, hkv, ps = 24, 2, 64
    ctx, qls = ([40, 10 * ps + 3, 0, ps], [1, 1, 1, 1]) if c == 1 else (
        [0, 10 * ps + 3, 17], [c, max(1, c // 2), 1])
    args, desc = _wq_case(rng, ctx, qls, c, hq, hkv, ps, len(ctx) + 1)
    plan = _wq_exact(args, desc, qls)
    assert plan.rows == (16 if c == 1 else 32)


@pytest.mark.cuda
def test_wq_prefill_scratch_scores_exact_on_card():
    """K9 with a chunk longer than its scores' shared-memory room (C =
    1,300 at 32-row tiles): the scores go to the scratch buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(11)
    args, desc = _wq_case(rng, [70, 0], [1300, 5], 1300, 4, 1, 64, 2)
    _wq_exact(args, desc, [1300, 5])


@pytest.mark.cuda
@pytest.mark.parametrize("g", GROUPS)
def test_dense_decode_exact_on_card(g):
    """K6 bit for bit against its plain version: lengths 1, ps−1, ps,
    ps+1, 487 and a long row, −1 table entries past each row's pages,
    shared and per-row scales."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(20 + g)
    hkv, ps, d = 2, 64, 128
    lens = [1, ps - 1, ps, ps + 1, 487, 6000]
    need = [-(-n // ps) for n in lens]
    num_pages = sum(need) + 3
    tbl = np.full((len(lens), max(need) + 2), -1, np.int32)
    perm = rng.permutation(num_pages)
    i = 0
    for bi, n in enumerate(need):
        tbl[bi, :n] = perm[i:i + n]
        i += n
    pools = [_cuda(rng.integers(0, 256, (num_pages, ps, hkv, d // 2))
                   .astype(np.uint8)) for _ in range(2)]
    stats = [_cuda(rng.uniform(lo, hi, (hkv, 1, d)).astype(np.float32))
             for lo, hi in ((0.05, 0.2), (6, 9), (0.05, 0.2), (6, 9))]
    q = _cuda(rng.normal(size=(len(lens), g * hkv, d)).astype(np.float32))
    lengths = _cuda(np.asarray(lens, np.int32))
    per_row = [_cuda(rng.uniform(lo, hi, (len(lens), hkv, 1, d))
                     .astype(np.float32))
               for lo, hi in ((0.05, 0.2), (6, 9), (0.05, 0.2), (6, 9))]
    for ks, kz, vs, vz in (stats, per_row):
        args = (q, pools[0], ks, kz, pools[1], vs, vz, _cuda(tbl), lengths)
        got = PA.paged_kv4_decode_attention(*args)
        want = PA.paged_kv4_decode_attention_ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
def test_wq_decode_exact_combine_on_card():
    """K8's op (partials, the exact combine and the V affine in one
    launch) bit for bit against its plain version, with the host's work
    plan, with a bare combine plan and with none (both: the plan is built
    from the descriptors)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(30)
    hq, hkv, ps, d = 8, 2, 64, 128
    lens = [487, 405, 1, 64, 700]
    need = [-(-n // ps) for n in lens]
    num_pages = sum(need) + 1
    tbl = np.full((len(lens), max(need)), -1, np.int32)
    perm = rng.permutation(num_pages)
    i = 0
    for bi, n in enumerate(need):
        tbl[bi, :n] = perm[i:i + n]
        i += n
    pools = [_cuda(rng.integers(0, 256, (num_pages, ps, hkv, d // 2))
                   .astype(np.uint8)) for _ in range(2)]
    ks, kz, vs, vz = [_cuda(rng.uniform(lo, hi, (hkv, 1, d))
                            .astype(np.float32))
                      for lo, hi in ((0.05, 0.2), (6, 9), (0.05, 0.2),
                                     (6, 9))]
    q = _cuda(rng.normal(size=(len(lens), hq, d)).astype(np.float32))
    desc = build_work_queue(tbl, lens, ps, hkv)
    plan = PA.combine_plan(desc[:, 0], len(lens) * hkv, "cuda")
    args = (q, pools[0], ks, kz, pools[1], vs, vz, _cuda(desc))
    want = PA.paged_kv4_decode_attention_wq_ref(*args, plan=plan)
    wplan = PA.work_plan(desc, len(lens) * hkv, 1, hq // hkv, "cuda")
    for p in (wplan, plan, None):
        got = PA.paged_kv4_decode_attention_wq(*args, plan=p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), float((got - want).abs().max())


def _decode_pools(rng, lens, ps, hkv, d=128):
    """Pools holding ``lens`` tokens per row on scattered pages, a table
    with −1 past each row's pages, and the rows' work-queue descriptors
    (a length-0 row has no items; count-0 pad items fill the power of
    two)."""
    need = [-(-n // ps) for n in lens]
    num_pages = sum(need) + 3
    tbl = np.full((len(lens), max(need) + 1), -1, np.int32)
    perm = rng.permutation(num_pages)
    i = 0
    for bi, n in enumerate(need):
        tbl[bi, :n] = perm[i:i + n]
        i += n
    pools = [_cuda(rng.integers(0, 256, (num_pages, ps, hkv, d // 2))
                   .astype(np.uint8)) for _ in range(2)]
    return pools, tbl, build_work_queue(tbl, lens, ps, hkv)


def _scale_sets(rng, b, hkv, d=128):
    """Shared [Hkv, 1, D] and per-batch [B, Hkv, 1, D] scales and zeros."""
    ranges = ((0.05, 0.2), (6, 9), (0.05, 0.2), (6, 9))
    return ([_cuda(rng.uniform(lo, hi, (hkv, 1, d)).astype(np.float32))
             for lo, hi in ranges],
            [_cuda(rng.uniform(lo, hi, (b, hkv, 1, d)).astype(np.float32))
             for lo, hi in ranges])


@pytest.mark.cuda
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("ps", [16, 64, 128])
def test_wq_decode_exact_on_card(ps, g):
    """K8 bit for bit against its plain version on every output row, in
    one launch a call: pages of 16, 64 and 128 keys, lengths 1, 63, 64,
    65, 487 and 6,000 (rows of 11+ items), a row with no items (the
    affine of an empty combine, −s_v·z_v), count-0 pad items, shared and
    per-batch scales, the engine's host plan and none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(40 + 10 * g + ps)
    hkv, d = 2, 128
    lens = [1, 63, 64, 65, 487, 6000, 0]
    pools, _, desc = _decode_pools(rng, lens, ps, hkv)
    assert (desc[:, 2] == 0).any()
    assert np.bincount(desc[desc[:, 2] > 0, 0]).max() >= 11
    b = len(lens)
    q = _cuda(rng.normal(size=(b, g * hkv, d)).astype(np.float32))
    plan = PA.work_plan(desc, b * hkv, 1, g, "cuda")
    for ks, kz, vs, vz in _scale_sets(rng, b, hkv):
        args = (q, pools[0], ks, kz, pools[1], vs, vz, _cuda(desc))
        before = PA.paged_kv4_decode_attention_wq.launches
        got = PA.paged_kv4_decode_attention_wq(*args, plan=plan)
        assert PA.paged_kv4_decode_attention_wq.launches == before + 1
        again = PA.paged_kv4_decode_attention_wq(*args)   # plan from desc
        want = PA.paged_kv4_decode_attention_wq_ref(*args, plan=plan)
        _exact(got, want)
        assert torch.equal(got, again)   # deterministic, whoever arrives last
        assert torch.equal(got[-1], (-(vs * vz)).expand(
            b, hkv, g, d)[-1].reshape(g * hkv, d))


@pytest.mark.cuda
def test_wq_decode_is_one_launch_on_card():
    """K8's whole op puts one kernel on the card (``torch.profiler``),
    with bf16 queries and the host plan, as the engine calls it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(50)
    hkv, g, ps, d = 2, 4, 128, 128
    lens = [487, 40, 300]
    pools, _, desc = _decode_pools(rng, lens, ps, hkv)
    (ks, kz, vs, vz), _ = _scale_sets(rng, len(lens), hkv)
    q = _cuda(rng.normal(size=(len(lens), g * hkv, d)).astype(np.float32)
              ).bfloat16()
    plan = PA.work_plan(desc, len(lens) * hkv, 1, g, "cuda")
    args = (q, pools[0], ks, kz, pools[1], vs, vz, _cuda(desc))
    assert _device_launches(
        lambda: PA.paged_kv4_decode_attention_wq(*args, plan=plan)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("g", GROUPS)
def test_contiguous_decode_exact_on_card(g):
    """K10 on the dense kernel bit for bit against its plain version: T
    not a multiple of 8 (70, 487), lengths 1 and below T, T = 6,000, and
    T = 50,000, whose scores go to scratch (checked through
    :func:`dense_plan`); shared and per-batch scales, f32 and bf16
    queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(60 + g)
    hkv, d = 2, 128
    for t, lens in ((70, [70, 1, 33]), (487, [487, 1, 486, 200]),
                    (6000, [6000, 5999, 64]), (50_000, [50_000, 3])):
        b = len(lens)
        plan = KA.dense_plan(b, 1, g, hkv, 1, t)
        assert (plan.scratch > 0) == (t == 50_000), plan
        kp, vp = [_cuda(rng.integers(0, 256, (b, hkv, t, d // 2))
                        .astype(np.uint8)) for _ in range(2)]
        q = _cuda(rng.normal(size=(b, g * hkv, d)).astype(np.float32))
        lengths = _cuda(np.asarray(lens, np.int32))
        for (ks, kz, vs, vz), qq in zip(_scale_sets(rng, b, hkv),
                                        (q, q.bfloat16())):
            args = (qq, kp, ks, kz, vp, vs, vz, lengths)
            _exact(KA.kv4_decode_attention(*args),
                   KA.kv4_decode_attention_ref(*args))



def _verify_state(rng, ctx, hq, hkv, ps, c, num_pages=24):
    """Pools with random history, one row of ctx + c positions whose
    chunk k/v is written into its pages (int4) and returned fake-quantized
    (the in-flight values the engine feeds K9), bf16-valued queries."""
    from repro_torch.serving import kv_cache as KVC
    d = 128
    need = -(-(ctx + c) // ps)
    tbl = np.full((1, need + 1), -1, np.int32)
    tbl[0, :need] = rng.permutation(num_pages)[:need]
    kp, vp = [_cuda(rng.integers(0, 256, (num_pages, ps, hkv, d // 2))
                    .astype(np.uint8)) for _ in range(2)]
    ks, kz, vs, vz = [_cuda(rng.uniform(lo, hi, (hkv, 1, d))
                            .astype(np.float32))
                      for lo, hi in ((0.05, 0.2), (6, 9), (0.05, 0.2),
                                     (6, 9))]
    k, v = [_cuda((rng.normal(size=(1, c, hkv, d)) * 0.8).astype(np.float32))
            for _ in range(2)]
    kq, vq = KVC.quantize_kv_with(k, v, ks, kz, vs, vz)
    pos = ctx + np.arange(c)
    pages = _cuda(tbl[0, pos // ps].astype(np.int64))
    offs = _cuda((pos % ps).astype(np.int64))
    kp[pages, offs] = kq[0].transpose(0, 1)
    vp[pages, offs] = vq[0].transpose(0, 1)
    kdq, vdq = KVC.qdq_kv_with(k, v, ks, kz, vs, vz)
    q = _cuda(rng.normal(size=(1, c, hq, d)).astype(np.float32)).bfloat16()
    return tbl, q, kdq, vdq, (kp, ks, kz, vp, vs, vz)


@pytest.mark.cuda
@pytest.mark.parametrize("ctx,ps", [(30, 16), (64, 16), (45, 16), (191, 64)])
def test_wq_verify_chunk_equals_decode_steps_on_card(ctx, ps):
    """K9 over a verify chunk of 5 (``build_work_queue(verify=...)``) bit
    for bit against its plain version, and its query i ``torch.equal`` to
    K9 over the decode step of the same token at ctx + i."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(ctx + ps)
    hq, hkv, c = 8, 2, 5
    tbl, q, kdq, vdq, pools = _verify_state(rng, ctx, hq, hkv, ps, c)

    def k9(q, kn, vn, desc):
        desc = np.asarray(desc)
        plan = PA.work_plan(desc, hkv, q.shape[1], hq // hkv, "cuda")
        args = (q, kn, vn, *pools, _cuda(desc))
        got = PA.paged_kv4_prefill_attention_wq(*args, plan=plan)
        want = PA.paged_kv4_prefill_attention_wq_ref(*args, plan=plan)
        assert torch.equal(got, want)
        return got

    chunk = k9(q, kdq, vdq,
               build_work_queue(tbl, [ctx], ps, hkv, [c], verify=[True]))
    for i in range(c):
        one = k9(q[:, i:i + 1].contiguous(), kdq[:, i:i + 1].contiguous(),
                 vdq[:, i:i + 1].contiguous(),
                 build_work_queue(tbl, [ctx + i], ps, hkv, [1]))
        assert torch.equal(chunk[0, i], one[0, 0]), i


@pytest.mark.cuda
def test_norms_are_batch_invariant_on_card():
    """RMSNorm and LayerNorm give a row the same bits alone and inside
    batches of 16 to 1,024 rows, at the first and the last row, on rows
    of ordinary and of large magnitude (``layers/common.py:row_mean``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.layers import common as C
    gen = torch.Generator(device="cuda").manual_seed(3)
    d = 4096
    x = torch.randn((1, 1024, d), generator=gen, device="cuda")
    x[:, ::3] *= 300.0
    x = x.bfloat16()
    scale = torch.rand(d, generator=gen, device="cuda") + 0.5
    bias = torch.randn(d, generator=gen, device="cuda")
    for fn in (lambda t: C.rmsnorm(t, scale),
               lambda t: C.layernorm(t, scale, bias)):
        alone = fn(x[:, :8])
        for t in (16, 32, 64, 128, 256, 512, 1024):
            y = x[:, :t].clone()
            y[:, t - 8:] = x[:, :8]
            out = fn(y)
            assert torch.equal(out[:, :8], alone), t
            assert torch.equal(out[:, t - 8:], alone), t


def _expert_operands(rng, e, c, nb4, nb8, n, spare=0):
    """Expert-batched operands: ``[E, C, ·]`` activations (the last row of
    each expert zero, an empty capacity slot) and a weight stack of
    ``nb4 + nb8 + spare`` blocks, of which the GEMM reads the first
    ``nb4 + nb8`` (a view whose expert stride is the whole stack's)."""
    a4 = rng.integers(0, 256, (e, c, nb4 * 64)).astype(np.uint8)
    a8 = rng.integers(-128, 128, (e, c, nb8 * 128)).astype(np.int8)
    a4[:, -1], a8[:, -1] = 0x88, 0             # code 8 / 0: a zero row
    nb = nb4 + nb8
    w = _cuda(rng.integers(0, 256, (e, (nb + spare) * 64, n)).astype(np.uint8))
    ws = _cuda(rng.uniform(0.001, 0.05, (e, nb + spare, n)).astype(np.float32))
    return (_cuda(a4), _cuda(rng.uniform(0.01, 0.2, (e, c, nb4))
                             .astype(np.float32)),
            _cuda(a8), _cuda(rng.uniform(0.001, 0.02, (e, c, nb8))
                             .astype(np.float32)),
            w[:, :nb * 64], ws[:, :nb])


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,nb4,nb8,n,spare", [
    (8, 4, 14, 2, 1408, 0),      # Moonlight's gate/up widths, decode tile
    (8, 30, 10, 1, 2048, 0),     # its down projection, prefill tile
    (5, 17, 3, 2, 68, 1),        # ragged N, a sliced stack
    (3, 65, 2, 3, 200, 0),
    (2, 1, 0, 2, 64, 0),         # uniform parts: K5 falls back
    (2, 9, 2, 0, 64, 0)])
def test_expert_gemms_match_plain_and_loop_on_card(e, c, nb4, nb8, n, spare):
    """The expert-batched K3, K4 (both conversions) and K5, one launch for
    all experts, bit for bit against their plain versions and against a
    loop of the single-expert kernel over the experts, on both tiles,
    with empty (zero) capacity rows and a stack view whose expert stride
    is larger than one expert's operand; each counts one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(e * 1000 + c)
    a4, s4, a8, s8, w, ws = _expert_operands(rng, e, c, nb4, nb8, n, spare)
    w4, ws4 = w[:, :nb4 * 64], ws[:, :nb4]
    w8, ws8 = w[:, nb4 * 64:], ws[:, nb4:]
    if nb4:
        for conv in ("zeroext", "signext"):
            before = WK.w4a4_matmul_experts.launches
            got = WK.w4a4_matmul_experts(a4, s4, w4, ws4, conversion=conv)
            assert WK.w4a4_matmul_experts.launches == before + 1
            assert torch.equal(got, WK.w4a4_matmul_ref(a4, s4, w4, ws4))
            loop = torch.stack([WK.w4a4_matmul(
                a4[i], s4[i], w4[i].contiguous(), ws4[i].contiguous(),
                conversion=conv) for i in range(e)])
            assert torch.equal(got, loop), conv
    if nb8:
        for conv in ("zeroext", "signext"):
            got = WK.w4a8_matmul_experts(a8, s8, w8, ws8, conversion=conv)
            assert torch.equal(got, WK.w4a8_matmul_ref(a8, s8, w8, ws8))
            loop = torch.stack([WK.w4a8_matmul(
                a8[i], s8[i], w8[i].contiguous(), ws8[i].contiguous(),
                conversion=conv) for i in range(e)])
            assert torch.equal(got, loop), conv
    before = WK.w4ax_matmul_mixed_experts.launches
    got = WK.w4ax_matmul_mixed_experts(a4, s4, a8, s8, w, ws)
    assert WK.w4ax_matmul_mixed_experts.launches == before + int(
        nb4 > 0 and nb8 > 0)
    assert torch.equal(got, WK.w4ax_matmul_mixed_ref(a4, s4, a8, s8, w, ws))
    loop = torch.stack([WK.w4ax_matmul_mixed(
        a4[i], s4[i], a8[i], s8[i], w[i].contiguous(), ws[i].contiguous())
        for i in range(e)])
    assert torch.equal(got, loop)
    split = WK.w4ax_matmul_split_experts(a4, s4, a8, s8, w, ws)
    want = WK.w4ax_matmul_ref(a4, s4, a8, s8, w4, ws4, w8, ws8)
    assert torch.equal(split, want)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["split", "mixed"])
def test_planned_projection_kernels_equal_plain_on_card(schedule):
    """An FMPQ-planned projection (the input gathered by ``perm`` before
    the fused act-quant) through the kernels, ``torch.equal`` to
    ``impl="ref"`` on the card, directly (the plan's K4) and through the
    dispatcher (the fraction's); one fused act-quant launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    import dataclasses
    from repro_torch.core import fmpq as F
    from repro_torch.core import qlinear as QL
    from repro_torch.models.lm import QuantConfig
    rng = np.random.default_rng(70)
    k, n = 1024, 768
    w = _cuda((rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32))
    cal = rng.normal(size=(256, k)).astype(np.float32)
    out = rng.choice(k, 24, replace=False)
    cal[:, out] *= 50
    plan = F.plan_fmpq(np.abs(cal).max(0))
    assert 0 < plan.k4 < k
    qp, spec = QL.quantize_linear(w, plan, schedule=schedule, impl="cuda")
    for m in (1, 8, 77, 256):
        x = rng.normal(size=(m, k)).astype(np.float32)
        x[:, out] *= 50
        x = _cuda(x).bfloat16()
        before = AQ.act_quant_w4ax.launches
        got = QL.qlinear_apply(spec, qp, x)
        assert AQ.act_quant_w4ax.launches == before + 1
        _exact(got.float(), QL.qlinear_apply(
            dataclasses.replace(spec, impl="ref"), qp, x).float())
        q = QuantConfig(schedule=schedule)
        _exact(QL.dispatch_qlinear(qp, x, q).float(), QL.dispatch_qlinear(
            qp, x, dataclasses.replace(q, impl="ref")).float())


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4, 8])
def test_contiguous_decode_long_cache_exact_on_card(g):
    """K10 over a contiguous cache of T = 1,024 slots holding 512–544
    keys (``LM.decode``'s cache: T is ``max_len``, far past the lengths),
    one "page" of T keys in its plan, bit for bit its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.kernels import ops
    rng = np.random.default_rng(80 + g)
    hkv, d, t = 8 if g == 4 else 2, 128, 1024
    lens = [512, 513, 520, 527, 530, 536, 543, 544]
    b = len(lens)
    kp, vp = [_cuda(rng.integers(0, 256, (b, hkv, t, d // 2))
                    .astype(np.uint8)) for _ in range(2)]
    q = _cuda(rng.normal(size=(b, g * hkv, d)).astype(np.float32)).bfloat16()
    lengths = _cuda(np.asarray(lens, np.int32))
    for ks, kz, vs, vz in _scale_sets(rng, b, hkv):
        args = (q, kp, ks, kz, vp, vs, vz, lengths)
        before = KA.kv4_decode_attention.launches
        got = ops.kv4_decode_attention(*args, impl="cuda")
        assert KA.kv4_decode_attention.launches == before + 1
        _exact(got, ops.kv4_decode_attention(*args, impl="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("kv4", [True, False])
def test_lm_generate_kernels_equal_ref_on_card(kv4):
    """``LM.prefill`` + 3 ``decode`` steps of a 2-layer model (head_dim
    128, an INT8 tail in every projection, planned q/k/v) with the
    kernels and with ``impl="ref"`` on the card: the same logits, bit
    for bit; K10 launched once a layer a decode step under ``kv4``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import fmpq as F
    from repro_torch.models.lm import LM, QuantConfig
    cfg = ModelConfig(name="card-lm", family="dense", num_layers=2,
                      d_model=512, num_heads=4, num_kv_heads=2, head_dim=128,
                      d_ff=1024, vocab_size=256)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lm = LM(cfg)
    rng = np.random.default_rng(90)
    blocks = []
    for _ in range(cfg.num_layers):
        cal = rng.normal(size=(64, cfg.d_model))
        cal[:, rng.choice(cfg.d_model, 12, replace=False)] *= 40
        plan = F.plan_fmpq(np.abs(cal).max(0))
        blocks.append(lm.quantize_block(lm.init_block(gen, "cuda"),
                                        {"wq": plan, "wk": plan, "wv": plan}))
    params = lm.init(seed=1, device="cuda")
    params["blocks"] = blocks
    tokens = torch.randint(0, cfg.vocab_size, (3, 40), device="cuda",
                           generator=gen)
    runs = {}
    for impl in ("cuda", "ref"):
        m = LM(cfg, QuantConfig(impl=impl, int4_fraction=0.75, kv4=kv4))
        cache = m.init_cache(3, 64, device="cuda")
        before = KA.kv4_decode_attention.launches
        logits, cache = m.prefill(params, tokens, cache)
        out = [logits]
        for _ in range(3):
            logits, cache = m.decode(params, logits.argmax(-1), cache)
            out.append(logits)
        launched = KA.kv4_decode_attention.launches - before
        runs[impl] = torch.cat(out, 1)
        if impl == "cuda":
            assert launched == (3 * cfg.num_layers if kv4 else 0)
    _exact(runs["cuda"], runs["ref"])


@pytest.mark.cuda
def test_converted_planned_params_quantize_each_input_once_on_card():
    """Planned params through ``convert.params_from_jax`` onto the card,
    every projection with its own ``perm`` array (the reference's tree):
    q/k/v and up/gate share one tensor a layer, so a forward launches the
    fused act-quant 4 times a layer and compares no permutation on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.configs.base import ModelConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.core import fmpq as F
    from repro_torch.models.lm import LM, QuantConfig
    cfg = ModelConfig(name="card-lm", family="dense", num_layers=2,
                      d_model=512, num_heads=4, num_kv_heads=2, head_dim=128,
                      d_ff=1024, vocab_size=256)
    lm = LM(cfg)
    gen = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(91)

    def plan():
        cal = rng.normal(size=(64, cfg.d_model))
        cal[:, rng.choice(cfg.d_model, 12, replace=False)] *= 40
        return F.plan_fmpq(np.abs(cal).max(0))

    layers = []
    for _ in range(cfg.num_layers):
        pq, pf = plan(), plan()
        layers.append(lm.quantize_block(lm.init_block(gen, "cpu"), {
            "wq": pq, "wk": pq, "wv": pq, "w_up": pf, "w_gate": pf}))

    def stacked(*xs):
        if isinstance(xs[0], dict):
            return {k: stacked(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack([x.numpy().copy() for x in xs])

    params = lm.init(seed=1, device="cuda")
    params["blocks"] = params_from_jax({"blocks": stacked(*layers)},
                                       device="cuda")["blocks"]
    for b in params["blocks"]:
        assert b["attn"]["wq"]["perm"] is b["attn"]["wk"]["perm"] \
            is b["attn"]["wv"]["perm"]
        assert b["mlp"]["w_up"]["perm"] is b["mlp"]["w_gate"]["perm"]
    m = LM(cfg, QuantConfig(impl="cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), device="cuda")
    before = AQ.act_quant_w4ax.launches
    logits, _ = m.prefill(params, tokens, m.init_cache(2, 32, device="cuda"))
    assert AQ.act_quant_w4ax.launches - before == 4 * cfg.num_layers
    assert torch.isfinite(logits).all()


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [80, 64, 32])
def test_contiguous_decode_head_dim_80_exact_on_card(g, d):
    """K10 at head_dim 80 (Zamba2's attention; 40-byte packed rows
    staged by 8-byte copies), and at the smoke configs' 32 and the TP test
    model's 64 (16- and 32-byte rows), bit for bit against its plain
    version: T even (1,024 holding 512–544 keys; 6,000), odd (487) and not
    a multiple of the 64-key tile (70), lengths 1 and T, shared and
    per-batch scales, f32 and bf16 queries, one launch a call; a width not
    built (96) raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(240 + g + d)
    hkv = 4
    for t, lens in ((1024, [512, 517, 526, 544]), (70, [70, 1, 33]),
                    (487, [487, 1, 486, 200]), (6000, [6000, 5999, 64])):
        b = len(lens)
        kp, vp = [_cuda(rng.integers(0, 256, (b, hkv, t, d // 2))
                        .astype(np.uint8)) for _ in range(2)]
        q = _cuda(rng.normal(size=(b, g * hkv, d)).astype(np.float32))
        lengths = _cuda(np.asarray(lens, np.int32))
        for (ks, kz, vs, vz), qq in zip(_scale_sets(rng, b, hkv, d),
                                        (q, q.bfloat16())):
            args = (qq, kp, ks, kz, vp, vs, vz, lengths)
            before = KA.kv4_decode_attention.launches
            got = KA.kv4_decode_attention(*args)
            assert KA.kv4_decode_attention.launches == before + 1
            _exact(got, KA.kv4_decode_attention_ref(*args))
    z = torch.zeros((1, 2, 8, 48), dtype=torch.uint8, device="cuda")
    s = torch.ones((2, 1, 96), device="cuda")
    with pytest.raises(ValueError,
                       match="head_dim 32, 64, 80 and 128, got 96"):
        KA.kv4_decode_attention(
            torch.zeros((1, 2, 96), device="cuda"), z, s, s, z, s, s,
            torch.ones(1, dtype=torch.int32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 80])
def test_paged_kernels_head_dims_exact_on_card(d, g):
    """K6, K7, K8 and K9 at head_dim 32, 64 and 80 (packed rows of 16, 32
    and 40 bytes; the last staged by 8-byte copies) bit for bit against
    their plain versions on the valid rows: K6 and K8 over lengths 1,
    ps−1, ps, ps+1, 487 and 6,000 and a row with no keys (K8: its empty
    combine's affine), pages of 16 and 64 keys, shared and per-batch
    scales; K7 and K9 at C = 1, 4 and 37 over rows with and without
    history and q_len-0 rows; a width not built (96) raises in each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    rng = np.random.default_rng(300 + 10 * g + d)
    hkv = 2
    for ps in (16, 64):
        lens = [1, ps - 1, ps, ps + 1, 487, 6000, 0]
        pools, tbl, desc = _decode_pools(rng, lens, ps, hkv, d)
        b = len(lens)
        q = _cuda(rng.normal(size=(b, g * hkv, d)).astype(np.float32))
        plan = PA.work_plan(desc, b * hkv, 1, g, "cuda")
        for (ks, kz, vs, vz), qq in zip(_scale_sets(rng, b, hkv, d),
                                        (q, q.bfloat16())):
            k6 = (qq, pools[0], ks, kz, pools[1], vs, vz, _cuda(tbl),
                  _cuda(np.asarray(lens, np.int32)))
            got = PA.paged_kv4_decode_attention(*k6)
            want = PA.paged_kv4_decode_attention_ref(*k6)
            torch.cuda.synchronize()
            valid = [i for i, n in enumerate(lens) if n]
            assert torch.equal(got[valid], want[valid]), (
                ps, float((got[valid] - want[valid]).abs().max()))
            k8 = (qq, pools[0], ks, kz, pools[1], vs, vz, _cuda(desc))
            _exact(PA.paged_kv4_decode_attention_wq(*k8, plan=plan),
                   PA.paged_kv4_decode_attention_wq_ref(*k8, plan=plan))
    for c, ctx, qls in ((1, [40, 0, 17, 5], [1, 1, 1, 0]),
                        (4, [40, 0, 17, 5], [4, 3, 1, 0]),
                        (37, [130, 0, 33], [37, 20, 0])):
        _dense_exact(_dense_case(rng, ctx, qls, c, g * hkv, hkv, 16, d=d),
                     qls)
        args, desc = _wq_case(rng, ctx, qls, c, g * hkv, hkv, 16,
                              len(ctx) + 1, d=d)
        _wq_exact(args, desc, qls)
    q = torch.zeros((1, 1, 2, 96), device="cuda")
    pool = torch.zeros((4, 16, 2, 48), dtype=torch.uint8, device="cuda")
    s = torch.ones((2, 1, 96), device="cuda")
    desc = _cuda(build_work_queue(np.zeros((1, 1), np.int32), [3], 16, 2,
                                  [1], pad_row=2))
    with pytest.raises(ValueError, match="got 96"):
        PA.paged_kv4_prefill_attention_wq(q, q[:, :, :2], q[:, :, :2], pool,
                                          s, s, pool, s, s, desc)
    with pytest.raises(ValueError, match="got 96"):
        PA.paged_kv4_decode_attention(
            q[0], pool, s, s, pool, s, s,
            torch.zeros((1, 1), dtype=torch.int32, device="cuda"),
            torch.ones(1, dtype=torch.int32, device="cuda"))


# one narrow model a family with the kernels' head_dims (80: Zamba2's,
# 128) and an INT8 tail in every projection (int4_fraction 0.5)
CARD_FAMILIES = {
    "hybrid": dict(num_layers=2, d_model=512, num_heads=8, num_kv_heads=8,
                   head_dim=80, d_ff=1024, vocab_size=256, ssm_state=64,
                   ssm_head_dim=64, ssm_chunk=128, attn_period=2,
                   rope_theta=10000.0),
    "ssm": dict(num_layers=2, d_model=512, num_heads=8, num_kv_heads=8,
                head_dim=64, d_ff=1024, vocab_size=256, rwkv_head_dim=64,
                rwkv_decay_lora=32),
    "vlm": dict(num_layers=2, d_model=512, num_heads=4, num_kv_heads=2,
                head_dim=128, d_ff=1024, vocab_size=256, cross_attn_period=2,
                num_image_tokens=40),
    "audio": dict(num_layers=2, d_model=512, num_heads=4, num_kv_heads=4,
                  head_dim=128, d_ff=1024, vocab_size=64, encoder_only=True,
                  causal=False, norm="layernorm", mlp_act="gelu",
                  conv_pos_width=16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(CARD_FAMILIES))
def test_family_kernels_equal_ref_on_card(family):
    """Each family's 2-layer model (one group for hybrid and vlm, the
    VLM's gates 0.5): ``prefill`` of 3 × 100 tokens and 4 greedy
    ``decode`` steps over the int4 cache with the kernels and with
    ``impl="ref"`` on the card, the same logits bit for bit (the
    encoder: ``train_logits``); K10 launched once per attention layer a
    decode step (at head_dim 80 for the hybrid)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.lm import LM, QuantConfig
    cfg = ModelConfig(name=f"card-{family}", family=family,
                      **CARD_FAMILIES[family])
    params = LM(cfg).init(seed=2, device="cuda")
    for cb in params.get("cross_blocks", []):
        cb["gate"].fill_(0.5)
    gen = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(1, cfg.vocab_size, (3, 100), device="cuda",
                           generator=gen)
    extra = ({"image_embeds": torch.randn((3, 40, 512), device="cuda",
                                          generator=gen)}
             if family == "vlm" else
             {"frames": torch.randn((3, 100, 512), device="cuda",
                                    generator=gen)}
             if family == "audio" else None)
    runs = {}
    for impl in ("cuda", "ref"):
        m = LM(cfg, QuantConfig(impl=impl, int4_fraction=0.5))
        if not cfg.has_decode:
            runs[impl] = m.train_logits(params, tokens, extra)[0]
            continue
        before = KA.kv4_decode_attention.launches
        cache = m.init_cache(3, 128, device="cuda")
        logits, cache = m.prefill(params, tokens, cache, extra)
        out = [logits]
        for _ in range(4):
            logits, cache = m.decode(params, logits.argmax(-1), cache)
            out.append(logits)
        runs[impl] = torch.cat(out, 1)
        if impl == "cuda":
            per_step = {"hybrid": 1, "vlm": 1}.get(family, 0)
            assert KA.kv4_decode_attention.launches - before == 4 * per_step
    _exact(runs["cuda"], runs["ref"])


@pytest.mark.cuda
def test_train_step_card_matches_cpu():
    """One ``make_train_step`` of the dense smoke model on the card and on
    the CPU from the same fp params and batch: the loss and grad norm to
    1e-3 and 1e-2, AdamW's first moment (0.1·g) leaf by leaf to 2e-2 of
    its max on the projections and 0.15 on the per-channel leaves (bf16
    products summed in cuBLAS's and the CPU's orders; ``chip_smoke.py``'s
    train phase holds every family so), the params moved alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train_loop import make_train_step
    cfg = get_smoke_config("llama3_8b")
    lm = LM(cfg)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=40,
                                      global_batch=2))
    lr = 1e-3
    res = {}
    for dev in ("cpu", "cuda"):
        params = OPT.tree_map(lambda t: t.to(dev), lm.init_fp(0, "cpu"))
        state = OPT.adamw_init(params)
        params, state, m = make_train_step(
            lm, OPT.AdamWConfig(lr=lr), loss_chunk=16)(
            params, state, data.batch_for_step(0, dev))
        res[dev] = (OPT.tree_leaves(OPT.tree_map(lambda t: t.cpu(), params)),
                    OPT.tree_leaves(OPT.tree_map(lambda t: t.cpu(),
                                                 state["m"])),
                    {k: float(v) for k, v in m.items()})
    (pc, mc, xc), (pg, mg, xg) = res["cpu"], res["cuda"]
    assert abs(xg["loss"] - xc["loss"]) <= 1e-3 * xc["loss"]
    assert abs(xg["grad_norm"] - xc["grad_norm"]) <= 1e-2 * xc["grad_norm"]
    for a, b in zip(mg, mc):
        tol = 0.15 if b.dim() <= 1 else 2e-2
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())
    dp = torch.cat([(a - b).abs().flatten() for a, b in zip(pg, pc)])
    assert float(dp.max()) <= 2 * lr * (1 + 1e-3)
    assert float(dp.mean()) <= 0.05 * lr


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(tmp_path):
    """Card tensors (f32, bf16, int32, a 0-d step) saved, blocking and in
    the background, and restored onto the card bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import optimizer as OPT
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = ({"w": torch.randn((64, 48), device="cuda", generator=gen),
             "blocks": [{"e": torch.randn(7, device="cuda", generator=gen)
                         .to(torch.bfloat16)} for _ in range(2)]},
            {"step": torch.tensor(5, dtype=torch.int32, device="cuda")})
    CKPT.save(str(tmp_path), 3, tree)
    CKPT.save_async(str(tmp_path), 4, tree)
    CKPT.wait_async()
    for step in (3, 4):
        got, s = CKPT.restore(str(tmp_path), tree, step=step,
                              device="cuda")
        assert s == step
        for a, b in zip(OPT.tree_leaves(got), OPT.tree_leaves(tree)):
            assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)
