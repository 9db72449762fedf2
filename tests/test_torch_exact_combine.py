"""The exact mode of the work-queue prefill op (K9) and its host plan, on
the CPU.

On the card, K9 computes its whole op — the pre-fold, one flash partial
per descriptor item and the split-KV combine — in float64 sums rounded
once, as its plain version does there (``exact`` mode). Here the plain
pieces run with ``exact=True`` on the CPU and are held to an independent
numpy float64 computation of the same formulas; the exact combine is held
to give the same float32 under any order of a row's items (what lets the
kernel's last-arriving block combine in any arrival order); the exact op
is held to the float32 op within 1e-5·max|ref|; and :func:`work_plan`,
the kernel's launch plan, is held to a direct computation of its jobs and
to a numpy run of the kernel's algorithm over them: every valid output
row combined once, from every item of its row, in descriptor order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.serving.kv_cache import build_work_queue

NEG = np.float32(-1e30)
F32 = np.float32


def _case(seed, ctx, qls, c, hq=8, hkv=2, ps=16, nb=None, d=128):
    """Seeded K9 inputs (numpy): pages scattered over the pool, q_len-0 pad
    rows up to ``nb``, bf16-valued queries."""
    rng = np.random.default_rng(seed)
    nb = nb or len(ctx)
    need = [max(1, -(-(cx + ql) // ps)) for cx, ql in zip(ctx, qls)]
    num_pages = sum(need) + 2
    tbl = np.full((len(ctx), max(need) + 1), -1, np.int32)
    perm = rng.permutation(num_pages)
    i = 0
    for bi, npg in enumerate(need):
        tbl[bi, :npg] = perm[i:i + npg]
        i += npg
    kp, vp = [rng.integers(0, 256, (num_pages, ps, hkv, d // 2))
              .astype(np.uint8) for _ in range(2)]
    ks, kz, vs, vz = [rng.uniform(lo, hi, (hkv, 1, d)).astype(F32)
                      for lo, hi in ((0.05, 0.2), (6, 9), (0.05, 0.2),
                                     (6, 9))]
    q = rng.normal(size=(nb, c, hq, d)).astype(F32)
    q = (q.view(np.uint32) & np.uint32(0xFFFF0000)).view(F32)
    kn, vn = [(rng.normal(size=(nb, c, hkv, d)) * 4).astype(F32)
              for _ in range(2)]
    desc = build_work_queue(tbl, ctx, ps, hkv, qls, pad_row=nb * hkv)
    return (q, kn, vn, kp, ks, kz, vp, vs, vz, desc)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32_of_f64_sum(prod, axis=-1):
    return prod.astype(np.float64).sum(axis).astype(F32)


def _nibbles(pool):
    """[..., D/2] uint8 → [..., D] f32 codes (channel j | j + D/2)."""
    return np.concatenate([pool & 15, pool >> 4], -1).astype(F32)


def _np_prefold(q, ks, kz, hkv):
    b, c, hq, d = q.shape
    g = hq // hkv
    sm = F32(1) / np.sqrt(F32(d))
    qg = np.moveaxis(q.reshape(b, c, hkv, g, d), 1, 2)       # [B,Hkv,C,G,D]
    qt = (qg * ks.reshape(1, hkv, 1, 1, d)).astype(F32) * sm
    cterm = _f32_of_f64_sum(qt.astype(np.float64)
                            * kz.reshape(1, hkv, 1, 1, d).astype(np.float64))
    return (qt.reshape(b * hkv, c * g, d), cterm.reshape(b * hkv, c * g, 1),
            (qg * sm).reshape(b * hkv, c * g, d))


def _np_partial(desc_row, qt, cterm, qs, kn2, vn2, kp, vp, vs, vz, g):
    """One item's (acc, l, m) over all C·G rows, in float64 sums rounded
    once, written out independently of the port."""
    row, page, count, kind = (int(x) for x in desc_row)
    nrows, cg, d = qt.shape
    r = min(row, nrows - 1)
    hkv = kp.shape[2]
    h = r % hkv
    if kind == 0:
        nk, nv = _nibbles(kp[page, :, h]), _nibbles(vp[page, :, h])
        dot = (qt[r].astype(np.float64) @ nk.T.astype(np.float64)).astype(F32)
        s = dot - cterm[r]
        s = np.where(np.arange(nk.shape[0])[None] < count, s, NEG)
        vals = nv
    else:
        c = kn2.shape[1]
        s = (qs[r].astype(np.float64) @ kn2[r].T.astype(np.float64)
             ).astype(F32)
        qi = np.arange(cg)[:, None] // g
        kj = np.arange(c)[None]
        s = np.where((kj <= qi) & (kj < count), s, NEG)
        vals = vn2[r]
    m = s.max(-1, keepdims=True)
    p = np.exp((s - m).astype(np.float64)).astype(F32)
    l = _f32_of_f64_sum(p)[:, None]
    acc = (p.astype(np.float64) @ vals.astype(np.float64)).astype(F32)
    if kind == 0:
        acc = acc * vs[h] - l * (vs[h] * vz[h])
    return acc, l, m


def _np_combine(acc, l, m):
    """Items of one row (in the given order) → [R, D]: the exact combine."""
    mx = np.maximum(m.max(0), NEG)
    w = np.exp((m - mx).astype(np.float64)).astype(F32).astype(np.float64)
    num = (w * acc.astype(np.float64)).sum(0).astype(F32)
    den = (w * l.astype(np.float64)).sum(0).astype(F32)
    return num / np.maximum(den, F32(1e-30))


CASES = [  # (seed, ctx, q_lens, C, nb)
    (1, [40, 0, 17], [1, 12, 5], 16, 4),       # decode, first, mid, a pad row
    (2, [150, 3], [1, 1], 1, 2),               # decode rows, 10 page items
    (3, [33, 64, 0, 7], [20, 1, 20, 3], 20, 6),
]


@pytest.mark.parametrize("seed,ctx,qls,c,nb", CASES)
def test_exact_prefold_matches_numpy(seed, ctx, qls, c, nb):
    q, kn, vn, kp, ks, kz, vp, vs, vz, desc = _case(seed, ctx, qls, c, nb=nb)
    qt2, c2, qs2, *_ = PA.prefold(_t(q), _t(kn), _t(vn), _t(ks), _t(kz),
                                  _t(vs), _t(vz), exact=True)
    want = _np_prefold(q, ks, kz, kp.shape[2])
    for got, w in zip((qt2, c2, qs2), want):
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("seed,ctx,qls,c,nb", CASES)
def test_exact_partials_match_numpy(seed, ctx, qls, c, nb):
    """Both item kinds, pad items included, bit for bit."""
    args = _case(seed, ctx, qls, c, nb=nb)
    q, kn, vn, kp, ks, kz, vp, vs, vz, desc = args
    hkv = kp.shape[2]
    g = q.shape[2] // hkv
    folded = PA.prefold(*[_t(a) for a in (q, kn, vn, ks, kz, vs, vz)],
                        exact=True)
    acc, l, m = PA.paged_kv4_partials_ref(_t(desc), *folded, _t(kp), _t(vp),
                                          g, exact=True)
    qt, cterm, qs = _np_prefold(q, ks, kz, hkv)
    b = q.shape[0]
    kn2 = np.moveaxis(kn, 1, 2).reshape(b * hkv, c, -1)
    vn2 = np.moveaxis(vn, 1, 2).reshape(b * hkv, c, -1)
    vs2, vz2 = vs.reshape(hkv, -1), vz.reshape(hkv, -1)
    for i, row in enumerate(desc):
        wa, wl, wm = _np_partial(row, qt, cterm, qs, kn2, vn2, kp, vp, vs2,
                                 vz2, g)
        np.testing.assert_array_equal(acc[i].numpy(), wa, err_msg=str(row))
        np.testing.assert_array_equal(l[i].numpy(), wl, err_msg=str(row))
        np.testing.assert_array_equal(m[i].numpy(), wm, err_msg=str(row))


def _partials(rng, w, r, d, nrows):
    acc = rng.normal(size=(w, r, d)).astype(F32) * 3
    l = rng.uniform(0.5, 40, size=(w, r, 1)).astype(F32)
    m = (rng.normal(size=(w, r, 1)) * 4).astype(F32)
    rows = np.sort(rng.integers(0, nrows, size=w)).astype(np.int32)
    return acc, l, m, rows


@pytest.mark.parametrize("seed", range(3))
def test_exact_combine_matches_numpy_in_any_item_order(seed):
    """The exact combine against numpy, and bit for bit the same result
    when a row's items come in another order (the kernel's combining
    block may be any of the row's): 12 rows of up to ~20 items, sentinel
    rows dropped, a row with no items 0."""
    rng = np.random.default_rng(seed)
    nrows, r, d = 12, 8, 128
    acc, l, m, rows = _partials(rng, 160, r, d, nrows + 1)   # + sentinels
    rows[rows == 3] = 4                                       # row 3: empty
    m[rows == 5] = NEG                # a row whose partials are all masked
    got = PA.combine_work_partials(_t(acc), _t(l), _t(m), _t(rows), nrows,
                                   exact=True)
    for row in range(nrows):
        sel = rows == row
        want = (_np_combine(acc[sel], l[sel], m[sel]) if sel.any()
                else np.zeros((r, d), F32))
        np.testing.assert_array_equal(got[row].numpy(), want, err_msg=row)
    for _ in range(4):
        perm = rng.permutation(len(rows))
        again = PA.combine_work_partials(
            _t(acc[perm]), _t(l[perm]), _t(m[perm]), _t(rows[perm]), nrows,
            exact=True)
        assert torch.equal(again, got)


@pytest.mark.parametrize("seed,ctx,qls,c,nb", CASES)
def test_exact_op_close_to_f32_op(seed, ctx, qls, c, nb):
    """The exact op differs from the f32 one (the CPU default) only by
    float32 summation order."""
    args = [_t(a) for a in _case(seed, ctx, qls, c, nb=nb)]
    exact = PA.paged_kv4_prefill_attention_wq_ref(*args, exact=True)
    f32 = PA.paged_kv4_prefill_attention_wq_ref(*args)
    assert torch.equal(f32, PA.paged_kv4_prefill_attention_wq_ref(
        *args, exact=False))
    err = float((exact - f32).abs().max())
    assert err <= 1e-5 * float(f32.abs().max()), err


def _direct_plan(desc, num_rows, c, g):
    """work_plan's rules by enumeration."""
    cg = c * g
    items = {}
    for i, (row, _, cnt, _) in enumerate(desc):
        if cnt > 0 and 0 <= row < num_rows:
            items.setdefault(int(row), []).append(i)
    valid = {}
    for row, its in items.items():
        chunk = [i for i in its if desc[i, 3] != 0]
        valid[row] = (min(int(desc[chunk[-1], 2]), c) * g if chunk else cg)
    top = max(valid.values(), default=0)
    rows = 8 if top <= 8 else 16 if top <= 16 else 32
    ntile = -(-cg // rows)
    compute, zero = [], []
    for row in range(num_rows):
        tiles = -(-valid.get(row, 0) // rows)
        for t in range(tiles):
            first = len(compute)
            for i in items[row]:
                compute.append((i, t, first, len(items[row])))
        zt = max(1, 256 // rows)
        for t0 in range(tiles, ntile, zt):
            zero.append((-1, t0, row, min(t0 + zt, ntile)))
    return rows, np.asarray(compute + zero, np.int64).reshape(-1, 4), \
        len(compute)


@pytest.mark.parametrize("seed,ctx,qls,c,nb,ps", [
    (1, [40, 0, 17], [1, 12, 5], 16, 4, 16),
    (2, [150, 3], [1, 1], 1, 2, 16),           # decode: 8-row tiles
    (3, [33, 64, 0, 7], [20, 1, 20, 3], 20, 6, 16),
    (4, [700, 5], [256, 256], 256, 2, 64),     # many 32-row tiles, zero jobs
    (5, [9, 30], [3, 4], 4, 3, 16),            # C·G = 16
])
def test_work_plan_matches_direct_computation_and_covers_rows(
        seed, ctx, qls, c, nb, ps):
    """The jobs against their rules written out, then the kernel's
    algorithm run over them in numpy: each (row, tile) group combines its
    row's items in descriptor order, zero jobs clear the rest; every
    output row of every batch row is written exactly once, and the valid
    rows equal the exact plain op."""
    args = _case(seed, ctx, qls, c, ps=ps, nb=nb)
    q, *_, desc = args
    b, _, hq, d = q.shape
    hkv = args[3].shape[2]
    g = hq // hkv
    plan = PA.work_plan(desc, b * hkv, c, g, "cpu")
    rows, jobs, ncompute = _direct_plan(desc, b * hkv, c, g)
    assert (plan.rows, plan.ncompute, plan.cg) == (rows, ncompute, c * g)
    np.testing.assert_array_equal(plan.jobs.numpy(), jobs)
    assert plan.jobs.dtype == torch.int32

    targs = [_t(a) for a in args]
    want = PA.paged_kv4_prefill_attention_wq_ref(*targs, plan=plan,
                                                 exact=True)
    folded = PA.prefold(*targs[:3], *targs[4:6], *targs[7:9], exact=True)
    acc, l, m = (x.numpy() for x in PA.paged_kv4_partials_ref(
        targs[-1], *folded, targs[3], targs[6], g, exact=True))
    out = np.full((b * hkv, c * g, d), np.nan, F32)
    writes = np.zeros((b * hkv, c * g), int)
    for j in range(ncompute):
        item, tile, first, cnt = jobs[j]
        if j != first + cnt - 1:       # the group's last job combines
            continue
        its = jobs[first:first + cnt, 0]
        assert (jobs[first:first + cnt, 1] == tile).all()
        assert (np.diff(its) > 0).all()            # descriptor order
        row = desc[its[0], 0]
        assert (desc[its, 0] == row).all()
        sl = slice(tile * rows, min(tile * rows + rows, c * g))
        out[row, sl] = _np_combine(acc[its, sl], l[its, sl], m[its, sl])
        writes[row, sl] += 1
    for _, t0, row, t1 in jobs[ncompute:]:
        sl = slice(t0 * rows, min(t1 * rows, c * g))
        out[row, sl] = 0
        writes[row, sl] += 1
    assert (writes == 1).all()
    out = np.moveaxis(out.reshape(b, hkv, c, g, d), 2, 1).reshape(
        b, c, hq, d)
    for bi, ql in enumerate(qls):
        np.testing.assert_array_equal(out[bi, :ql], want[bi, :ql].numpy())
    assert not out[len(qls):].any()               # q_len-0 pad rows: 0
