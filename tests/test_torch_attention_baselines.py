"""The plain versions of the baseline attention kernels (K6 dense paged
decode, K7 dense paged prefill, K8 work-queue decode, K10 contiguous
decode) against the reference's oracles on the CPU, plus the KV nibble
layout they all read.

Inputs are made from a seed with numpy and go through both packages. f32
results are held to 1e-4·max(1, max|ref|): the two sides sum in other
orders and use other ``exp`` implementations, nothing more. One small
case of each op also goes through the reference's Pallas kernel in
interpret mode. ``test_torch_card.py`` compares each CUDA kernel with its
plain version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as JQ
from repro.kernels import ops as JOPS
from repro.kernels import ref as JR
from repro.serving import kv_cache as JKVC
from repro_torch.core import quantizer as Q
from repro_torch.kernels import kv4_attention as KA
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ref as R
from repro_torch.serving import kv_cache as KVC

J_K6 = jax.jit(JR.paged_kv4_decode_attention_ref)
J_K7 = jax.jit(JR.paged_kv4_prefill_attention_ref)
J_K8 = jax.jit(JR.paged_kv4_decode_attention_wq_ref)
J_K10 = jax.jit(JR.kv4_decode_attention_ref, static_argnames="compute_dtype")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= 1e-4 * max(1.0, np.abs(want).max()), err


def _stats(rng, hkv, d, lead=()):
    def stat(lo, hi):
        return rng.uniform(lo, hi, size=lead + (hkv, 1, d)).astype(np.float32)
    return stat(0.05, 0.2), stat(6, 9), stat(0.05, 0.2), stat(6, 9)


def _pools(rng, lens, ps, hkv, d, np_cols=None):
    """Random pools and a shuffled block table covering ``lens`` tokens
    per row, unmapped (−1) past each row's pages."""
    need = [-(-n // ps) for n in lens]
    num_pages = sum(need) + 3
    kp, vp = [rng.integers(0, 256, size=(num_pages, ps, hkv, d // 2))
              .astype(np.uint8) for _ in range(2)]
    tbl = np.full((len(lens), np_cols or max(max(need), 1)), -1, np.int32)
    perm = rng.permutation(num_pages)
    i = 0
    for bi, n in enumerate(need):
        tbl[bi, :n] = perm[i:i + n]
        i += n
    return kp, vp, tbl


# ----------------------------------------------------------- KV layout

def test_kv_nibble_layout_and_dequant_match_reference():
    """Codes, packing (byte j = channel j | channel j + D/2 << 4) and the
    dequantization are elementwise: byte for byte and bit for bit."""
    rng = np.random.default_rng(0)
    k = rng.normal(size=(2, 9, 4, 64)).astype(np.float32) * 3
    v = rng.normal(size=(2, 9, 4, 64)).astype(np.float32) * 3
    ks, kz, vs, vz = _stats(rng, 4, 64)
    jk, jv = JKVC.quantize_kv_with(*[jnp.asarray(a) for a in
                                     (k, v, ks, kz, vs, vz)])
    tk, tv = KVC.quantize_kv_with(*[_t(a) for a in (k, v, ks, kz, vs, vz)])
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    codes = Q.unpack_kv_nibbles(tk)
    assert torch.equal(Q.pack_kv_nibbles(codes), tk)
    lo, hi = (tk & 15).float(), (tk >> 4).float()
    assert torch.equal(codes[..., :32], lo) and torch.equal(codes[..., 32:], hi)
    np.testing.assert_array_equal(
        Q.dequantize_kv_channelwise(tk, _t(ks), _t(kz)).numpy(),
        np.asarray(JQ.dequantize_kv_channelwise(jk, jnp.asarray(ks),
                                                jnp.asarray(kz))))


# ----------------------------------------------------- K10 contiguous KV

K10_CASES = [  # (b, hq, hkv, d, t, lengths)
    (3, 8, 2, 64, 70, [70, 33, 1]),
    (2, 4, 4, 128, 130, [129, 64]),
    (4, 16, 4, 32, 17, [5, 17, 16, 2]),
]


def _k10_case(rng, b, hq, hkv, d, t, lengths):
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    kp, vp = [rng.integers(0, 256, size=(b, hkv, t, d // 2)).astype(np.uint8)
              for _ in range(2)]
    ks, kz, vs, vz = _stats(rng, hkv, d, (b,))
    return q, kp, ks, kz, vp, vs, vz, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("b,hq,hkv,d,t,lengths", K10_CASES)
def test_kv4_decode_f32_matches_reference(b, hq, hkv, d, t, lengths):
    args = _k10_case(np.random.default_rng(t), b, hq, hkv, d, t, lengths)
    want = J_K10(*[jnp.asarray(a) for a in args])
    _close(R.kv4_decode_attention_ref(*[_t(a) for a in args]).numpy(), want)


@pytest.mark.parametrize("b,hq,hkv,d,t,lengths", K10_CASES)
def test_kv4_decode_bf16_op_matches_reference_op(b, hq, hkv, d, t, lengths):
    """The ops' ref path runs in bf16 on both sides (operands rounded to
    bf16, f32 products), held to the same 1e-4 as f32; the bf16 result
    itself differs from the f32 one by far more, so bf16 did run."""
    args = _k10_case(np.random.default_rng(t + 1), b, hq, hkv, d, t, lengths)
    want = JOPS.kv4_decode_attention(*[jnp.asarray(a) for a in args],
                                     impl="ref")
    got = OPS.kv4_decode_attention(*[_t(a) for a in args])
    _close(got.numpy(), want)
    f32 = J_K10(*[jnp.asarray(a) for a in args])
    assert np.abs(np.asarray(want) - np.asarray(f32)).max() > 1e-3


def test_kv4_decode_matches_pallas_interpret():
    args = _k10_case(np.random.default_rng(7), 2, 8, 2, 64, 48, [40, 9])
    want = JOPS.kv4_decode_attention(*[jnp.asarray(a) for a in args],
                                     impl="pallas", bt=16)
    _close(R.kv4_decode_attention_ref(*[_t(a) for a in args]).numpy(), want)


# ------------------------------------------------ K6 dense paged decode

K6_CASES = [  # (hq, hkv, d, ps, lengths, extra table columns)
    (8, 2, 64, 16, [40, 17, 1], 2),          # -1 entries past each row
    (4, 1, 128, 32, [100, 33, 64, 5], 0),
    (16, 8, 64, 64, [130, 65], 1),
]


def _k6_case(rng, hq, hkv, d, ps, lengths, extra):
    kp, vp, tbl = _pools(rng, lengths, ps, hkv, d)
    if extra:
        tbl = np.concatenate(
            [tbl, np.full((len(lengths), extra), -1, np.int32)], 1)
    q = rng.normal(size=(len(lengths), hq, d)).astype(np.float32)
    ks, kz, vs, vz = _stats(rng, hkv, d)
    return q, kp, ks, kz, vp, vs, vz, tbl, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("hq,hkv,d,ps,lengths,extra", K6_CASES)
def test_paged_decode_matches_reference(hq, hkv, d, ps, lengths, extra):
    args = _k6_case(np.random.default_rng(sum(lengths)), hq, hkv, d, ps,
                    lengths, extra)
    want = J_K6(*[jnp.asarray(a) for a in args])
    got = OPS.paged_kv4_decode_attention(*[_t(a) for a in args])
    _close(got.numpy(), want)


def test_paged_decode_matches_pallas_interpret():
    args = _k6_case(np.random.default_rng(3), 8, 2, 64, 16, [40, 17], 1)
    want = JOPS.paged_kv4_decode_attention(*[jnp.asarray(a) for a in args],
                                           impl="pallas")
    _close(OPS.paged_kv4_decode_attention(*[_t(a) for a in args]).numpy(),
           want)


# ----------------------------------------------- K8 work-queue decode

@pytest.mark.parametrize("hq,hkv,d,ps,lengths,extra", K6_CASES)
def test_paged_decode_wq_matches_reference(hq, hkv, d, ps, lengths, extra):
    """Descriptors from ``build_work_queue`` over real pages only, padded
    to a power of two with count-0 items on the sentinel row; both the
    combine's own read-back and the host plan give the same result."""
    rng = np.random.default_rng(sum(lengths) + 1)
    q, kp, ks, kz, vp, vs, vz, tbl, lens = _k6_case(
        rng, hq, hkv, d, ps, lengths, extra)
    desc = KVC.build_work_queue(tbl, lens, ps, hkv)
    assert (desc[:, 2] == 0).any()                    # pad items present
    args = (q, kp, ks, kz, vp, vs, vz, desc)
    want = J_K8(*[jnp.asarray(a) for a in args])
    targs = [_t(a) for a in args]
    got = OPS.paged_kv4_decode_attention_wq(*targs)
    _close(got.numpy(), want)
    plan = OPS.combine_plan(desc[:, 0], len(lengths) * hkv, "cpu")
    assert torch.equal(OPS.paged_kv4_decode_attention_wq(*targs, plan=plan),
                       got)


def test_paged_decode_wq_matches_pallas_interpret():
    rng = np.random.default_rng(4)
    q, kp, ks, kz, vp, vs, vz, tbl, lens = _k6_case(
        rng, 8, 2, 64, 16, [40, 17], 0)
    desc = KVC.build_work_queue(tbl, lens, 16, 2)
    args = (q, kp, ks, kz, vp, vs, vz, desc)
    want = JOPS.paged_kv4_decode_attention_wq(
        *[jnp.asarray(a) for a in args], impl="pallas")
    _close(OPS.paged_kv4_decode_attention_wq(*[_t(a) for a in args]).numpy(),
           want)


def test_decode_partials_of_pad_items():
    """A count-0 item leaves (acc, l, m) with m = NEG_INF, so its combine
    weight is exactly 0; a real item's l is ≥ 1."""
    rng = np.random.default_rng(5)
    q, kp, ks, kz, vp, vs, vz, tbl, lens = _k6_case(
        rng, 8, 2, 64, 16, [20], 0)
    desc = _t(KVC.build_work_queue(tbl, lens, 16, 2))
    qt2, c2 = PA.decode_prefold(_t(q), _t(ks), _t(kz), 2)
    acc, l, m = R.paged_kv4_decode_partials_ref(desc, qt2, c2, _t(kp),
                                                _t(vp))
    pad = desc[:, 2] == 0
    assert (m[pad] == PA.NEG_INF).all() and (l[~pad] >= 1).all()


# ------------------------------------------------ K7 dense paged prefill

K7_CASES = [  # (hq, hkv, d, ps, ctx, q_lens, c, nb)
    (8, 2, 64, 16, [40, 0, 17], [1, 12, 5], 16, 4),    # ctx 0 beside history
    (4, 1, 128, 32, [100, 33, 64, 5], [1, 1, 20, 8], 32, 4),
    (16, 4, 64, 16, [7, 200, 1], [3, 1, 16], 16, 8),   # 5 q_len-0 pad rows
    (8, 2, 64, 16, [0, 0], [9, 16], 16, 2),            # npages = 0
]


def _k7_case(rng, hq, hkv, d, ps, ctx, qls, c, nb):
    """Rows [len(ctx), nb) are the bucket's q_len-0 pad rows (ctx 0, an
    all −1 table row); the table has one extra unmapped column."""
    b = len(ctx)
    lens = [cx + ql for cx, ql in zip(ctx, qls)]
    kp, vp, tbl = _pools(rng, lens, ps, hkv, d)
    npb = 0 if max(ctx) == 0 else -(-max(ctx) // ps) + 1
    tables = np.full((nb, npb), -1, np.int32)
    tables[:b] = tbl[:, :npb] if npb <= tbl.shape[1] else np.pad(
        tbl, ((0, 0), (0, npb - tbl.shape[1])), constant_values=-1)
    q = rng.normal(size=(nb, c, hq, d)).astype(np.float32)
    kn = rng.normal(size=(nb, c, hkv, d)).astype(np.float32)
    vn = rng.normal(size=(nb, c, hkv, d)).astype(np.float32)
    ks, kz, vs, vz = _stats(rng, hkv, d)
    pad = [0] * (nb - b)
    return (q, kn, vn, kp, ks, kz, vp, vs, vz, tables,
            np.asarray(list(ctx) + pad, np.int32),
            np.asarray(list(qls) + pad, np.int32))


@pytest.mark.parametrize("hq,hkv,d,ps,ctx,qls,c,nb", K7_CASES)
def test_paged_prefill_matches_reference(hq, hkv, d, ps, ctx, qls, c, nb):
    """Valid query rows (i < q_len) match; every row is finite, the
    q_len-0 pad rows included."""
    args = _k7_case(np.random.default_rng(sum(ctx) + c), hq, hkv, d, ps,
                    ctx, qls, c, nb)
    want = np.asarray(J_K7(*[jnp.asarray(a) for a in args]))
    got = OPS.paged_kv4_prefill_attention(*[_t(a) for a in args]).numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    for bi, ql in enumerate(qls):
        _close(got[bi, :ql], want[bi, :ql])


def test_paged_prefill_matches_pallas_interpret():
    args = _k7_case(np.random.default_rng(6), 8, 2, 64, 16, [20, 0],
                    [1, 9], 16, 2)
    want = np.asarray(JOPS.paged_kv4_prefill_attention(
        *[jnp.asarray(a) for a in args], impl="pallas"))
    got = OPS.paged_kv4_prefill_attention(*[_t(a) for a in args]).numpy()
    for bi, ql in enumerate([1, 9]):
        _close(got[bi, :ql], want[bi, :ql])


# ------------------------------------------------------------ dispatch

def test_impl_cuda_on_cpu_tensors_raises():
    """``impl="cuda"`` on CPU tensors raises in every new op, and each
    kernel wrapper refuses CPU tensors instead of taking the plain
    version itself."""
    rng = np.random.default_rng(8)
    k10 = [_t(a) for a in _k10_case(rng, 2, 8, 2, 128, 40, [40, 9])]
    k6 = [_t(a) for a in _k6_case(rng, 8, 2, 128, 16, [40, 17], 0)]
    desc = _t(KVC.build_work_queue(k6[7].numpy(), [40, 17], 16, 2))
    k7 = [_t(a) for a in _k7_case(rng, 8, 2, 128, 16, [20, 0], [1, 9], 16, 2)]
    calls = [
        lambda: OPS.kv4_decode_attention(*k10, impl="cuda"),
        lambda: OPS.paged_kv4_decode_attention(*k6, impl="cuda"),
        lambda: OPS.paged_kv4_decode_attention_wq(*k6[:7], desc, impl="cuda"),
        lambda: OPS.paged_kv4_prefill_attention(*k7, impl="cuda"),
        lambda: KA.kv4_decode_attention(*k10),
        lambda: PA.paged_kv4_decode_attention(*k6),
        lambda: PA.paged_kv4_decode_attention_wq(*k6[:7], desc),
        lambda: PA.paged_kv4_prefill_attention(*k7),
    ]
    for call in calls:
        with pytest.raises(ValueError):
            call()
