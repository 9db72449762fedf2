"""Port kernel ops (plain versions on the CPU) vs the JAX reference.

W4Ax GEMMs are held to ``ref.w4ax_matmul_ref`` at 1e-5·max|ref| (f32
accumulation order differs); work-queue attention plus the combine to
1e-4·max(1, max|ref|) on descriptors from ``build_work_queue`` mixing
decode rows, mid-prefill rows, zero-history rows and pad items. One small
case of each also goes through the reference's Pallas kernel in interpret
mode. ``test_torch_card.py`` compares each CUDA kernel with its plain
version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import paged_attention as JPA
from repro.kernels import ref as JR
from repro.serving.kv_cache import build_work_queue as j_build_work_queue
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ref as R
from repro_torch.serving.kv_cache import build_work_queue


# the oracles run jitted (one compile per shape instead of one per op);
# everything here is f32, where jit changes at most the summation order
J_W4AX = jax.jit(JR.w4ax_matmul_ref)
J_WQ = jax.jit(JR.paged_kv4_prefill_attention_wq_ref)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _gemm_inputs(rng, m, nb4, nb8, n):
    a4 = rng.integers(0, 256, size=(m, nb4 * 64)).astype(np.uint8)
    s4 = rng.uniform(0.01, 0.2, size=(m, nb4)).astype(np.float32)
    a8 = rng.integers(-128, 128, size=(m, nb8 * 128)).astype(np.int8)
    s8 = rng.uniform(0.001, 0.02, size=(m, nb8)).astype(np.float32)
    w = rng.integers(0, 256, size=((nb4 + nb8) * 64, n)).astype(np.uint8)
    ws = rng.uniform(0.001, 0.05, size=(nb4 + nb8, n)).astype(np.float32)
    return a4, s4, a8, s8, w, ws


def _close(got, want, rel):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


GEMM_CASES = [  # (m, nb4, nb8, n)
    (1, 2, 1, 64), (5, 2, 3, 32), (16, 7, 1, 256), (9, 14, 2, 128),
    (3, 0, 2, 64), (8, 4, 0, 96)]


@pytest.mark.parametrize("m,nb4,nb8,n", GEMM_CASES)
def test_w4ax_split_matches_reference(m, nb4, nb8, n):
    rng = np.random.default_rng(m * 100 + nb4 * 10 + nb8)
    a4, s4, a8, s8, w, ws = _gemm_inputs(rng, m, nb4, nb8, n)
    k4p = nb4 * 64
    want = J_W4AX(a4, s4, a8, s8, w[:k4p], ws[:nb4], w[k4p:], ws[nb4:])
    got = OPS.w4ax_matmul(_t(a4), _t(s4), _t(a8), _t(s8), _t(w), _t(ws))
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("m,nb,n", [(1, 1, 32), (7, 3, 64), (16, 5, 128)])
def test_w4a4_and_w4a8_match_reference(m, nb, n):
    rng = np.random.default_rng(m + nb + n)
    a4, s4, a8, s8, w, ws = _gemm_inputs(rng, m, nb, nb, n)
    w, ws = w[:nb * 64], ws[:nb]
    _close(R.w4a4_matmul_ref(_t(a4), _t(s4), _t(w), _t(ws)).numpy(),
           JR.w4a4_matmul_ref(a4, s4, w, ws), 1e-5)
    _close(R.w4a8_matmul_ref(_t(a8), _t(s8), _t(w), _t(ws)).numpy(),
           JR.w4a8_matmul_ref(a8, s8, w, ws), 1e-5)


def test_w4ax_matches_pallas_interpret():
    rng = np.random.default_rng(11)
    a4, s4, a8, s8, w, ws = _gemm_inputs(rng, 8, 2, 1, 128)
    want = JOPS.w4ax_matmul(a4, s4, a8, s8, w, ws, impl="pallas")
    got = OPS.w4ax_matmul(_t(a4), _t(s4), _t(a8), _t(s8), _t(w), _t(ws))
    _close(got.numpy(), want, 1e-5)


def _paged_case(rng, hq, hkv, d, ps, ctx, qls, c, nb=None):
    """Pools with a shuffled block table; rows [len(ctx), nb) are qlen-0
    pad rows of a bucketed batch."""
    b = len(ctx)
    nb = nb or b
    need = [-(-(cx + ql) // ps) for cx, ql in zip(ctx, qls)]
    num_pages = sum(need) + 3
    kp = rng.integers(0, 256, size=(num_pages, ps, hkv, d // 2)).astype(np.uint8)
    vp = rng.integers(0, 256, size=(num_pages, ps, hkv, d // 2)).astype(np.uint8)
    tbl = np.full((b, max(need)), -1, np.int32)
    perm = rng.permutation(num_pages)
    i = 0
    for bi, nbp in enumerate(need):
        tbl[bi, :nbp] = perm[i:i + nbp]
        i += nbp
    def stat(lo, hi):
        return rng.uniform(lo, hi, size=(hkv, 1, d)).astype(np.float32)

    ks, kz, vs, vz = stat(0.05, 0.2), stat(6, 9), stat(0.05, 0.2), stat(6, 9)
    q = rng.normal(size=(nb, c, hq, d)).astype(np.float32)
    kn = rng.normal(size=(nb, c, hkv, d)).astype(np.float32)
    vn = rng.normal(size=(nb, c, hkv, d)).astype(np.float32)
    desc = build_work_queue(tbl, ctx, ps, hkv, qls, pad_row=nb * hkv)
    return (q, kn, vn, kp, ks, kz, vp, vs, vz, desc), tbl


WQ_CASES = [  # (hq, hkv, d, ps, ctx, q_lens, c, nb)
    (8, 2, 64, 16, [40, 0, 17], [1, 12, 5], 16, 4),     # decode, first, mid
    (4, 1, 128, 32, [100, 33, 64, 5], [1, 1, 20, 8], 32, 4),
    (8, 8, 128, 64, [130, 0], [64, 64], 64, 2),
    (16, 4, 64, 16, [7, 200, 1], [3, 1, 16], 16, 8),    # 5 pad rows
    # the other head_dims the kernels are built for: the smoke configs'
    # 32 and Zamba2's 80 (and 64 above)
    (8, 2, 32, 16, [40, 0, 17], [1, 12, 5], 16, 4),
    (16, 2, 32, 32, [100, 33, 5], [1, 20, 8], 32, 4),
    (4, 4, 80, 16, [70, 0, 33], [1, 16, 3], 16, 4),
    (8, 1, 80, 64, [130, 0], [64, 40], 64, 2),
]


@pytest.mark.parametrize("hq,hkv,d,ps,ctx,qls,c,nb", WQ_CASES)
def test_paged_wq_matches_reference(hq, hkv, d, ps, ctx, qls, c, nb):
    rng = np.random.default_rng(sum(ctx) + c)
    args, _ = _paged_case(rng, hq, hkv, d, ps, ctx, qls, c, nb)
    want = np.asarray(J_WQ(*[jnp.asarray(a) for a in args]))
    got = OPS.paged_kv4_prefill_attention_wq(*[_t(a) for a in args]).numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= 1e-4 * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("hq,hkv,d,ps,ctx,qls,c,nb", WQ_CASES)
def test_host_combine_plan_gives_same_result(hq, hkv, d, ps, ctx, qls, c,
                                             nb):
    """The combine plan the engine builds on the host from the descriptor
    array changes nothing: the result is bit for bit the one the combine
    gets by reading the rows back itself."""
    rng = np.random.default_rng(sum(ctx) + c + 1)
    args, _ = _paged_case(rng, hq, hkv, d, ps, ctx, qls, c, nb)
    targs = [_t(a) for a in args]
    plan = OPS.combine_plan(args[-1][:, 0], nb * hkv, "cpu")
    assert plan.kmax == max(np.bincount(args[-1][:, 0])[:nb * hkv].max(), 1)
    got = OPS.paged_kv4_prefill_attention_wq(*targs, plan=plan)
    assert torch.equal(got, OPS.paged_kv4_prefill_attention_wq(*targs))


def test_paged_wq_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    args, _ = _paged_case(rng, 8, 2, 64, 16, [20, 0], [1, 9], 16, 2)
    want = np.asarray(JOPS.paged_kv4_prefill_attention_wq(
        *[jnp.asarray(a) for a in args], impl="pallas"))
    got = OPS.paged_kv4_prefill_attention_wq(*[_t(a) for a in args]).numpy()
    for bi, ql in enumerate([1, 9]):          # rows past q_len are garbage
        err = np.abs(got[bi, :ql] - want[bi, :ql]).max()
        assert err <= 1e-4 * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("ctx,qls,ps,hkv,pad_row", [
    ([70, 9], [4, 0], 32, 2, None), ([0, 0, 5], [16, 3, 1], 8, 4, 32),
    ([300, 1, 64], [1, 1, 200], 64, 8, 64), ([128], None, 64, 2, None)])
def test_work_queue_matches_reference(ctx, qls, ps, hkv, pad_row):
    rng = np.random.default_rng(len(ctx))
    need = [-(-(c + (q or 0)) // ps) for c, q in
            zip(ctx, qls or [0] * len(ctx))]
    tbl = np.full((len(ctx), max(need) + 1), -1, np.int32)
    perm = rng.permutation(sum(need) + 4)
    i = 0
    for bi, n in enumerate(need):
        tbl[bi, :n] = perm[i:i + n]
        i += n
    np.testing.assert_array_equal(
        build_work_queue(tbl, ctx, ps, hkv, qls, pad_row=pad_row),
        j_build_work_queue(tbl, ctx, ps, hkv, qls, pad_row=pad_row))
    with pytest.raises(IndexError):
        build_work_queue(tbl, [c + ps * (max(need) + 2) for c in ctx], ps,
                         hkv)


def test_combine_matches_reference():
    rng = np.random.default_rng(9)
    w, r, d, nrows = 24, 6, 16, 5
    acc = rng.normal(size=(w, r, d)).astype(np.float32)
    l = rng.uniform(0.5, 4, size=(w, r, 1)).astype(np.float32)
    m = rng.normal(size=(w, r, 1)).astype(np.float32) * 3
    rows = rng.integers(0, nrows + 2, size=(w,)).astype(np.int32)  # sentinels
    rows[rows == 2] = 3                                   # row 2 stays empty
    m[-1] = -1e30                                   # a fully masked partial
    want = np.asarray(JPA.combine_work_partials(
        jnp.asarray(acc), jnp.asarray(l), jnp.asarray(m), jnp.asarray(rows),
        nrows))
    got = PA.combine_work_partials(_t(acc), _t(l), _t(m), _t(rows), nrows)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert (got[2] == 0).all()


def test_cuda_impl_on_cpu_raises():
    x = torch.zeros((2, 128))
    with pytest.raises(ValueError):
        OPS.act_quant(x, bits=4, impl="cuda")
    with pytest.raises(ValueError):
        OPS.act_quant(x, bits=4, impl="triton")


def test_attention_kernel_wrapper_refuses_cpu_tensors():
    """The K9 wrapper launches on CUDA tensors or raises; it never takes
    the plain version itself."""
    rng = np.random.default_rng(2)
    args, _ = _paged_case(rng, 8, 2, 128, 16, [20, 0], [1, 9], 16, 2)
    q, kn, vn, kp, ks, kz, vp, vs, vz, desc = [_t(a) for a in args]
    with pytest.raises(ValueError):
        PA.paged_kv4_prefill_attention_wq(q, kn, vn, kp, ks, kz, vp, vs, vz,
                                          desc)
    with pytest.raises(ValueError):
        OPS.paged_kv4_prefill_attention_wq(q, kn, vn, kp, ks, kz, vp, vs, vz,
                                           desc, impl="cuda")
