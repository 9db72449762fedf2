"""The work-queue decode op (K8) on the CPU: its plain version against the
reference, its exact mode, and its launch plan.

On the card, K8 is one launch of the work-queue kernel K9 runs, at C = 1:
one block per page item folds the row's queries (q̃ = (q·s_k)·(1/√D), c =
Σ q̃·z_k in float64 rounded once), leaves the item's nibble-space partial
(Σ p·n_v, Σ p, m) in scratch, and the last block of each row combines the
row's partials in descriptor order and applies the V affine s_v·comb −
s_v·z_v; a row with no item gets the affine of an empty combine, −s_v·z_v.
Here:

* the plain version's float32 mode (the CPU default) against the
  reference's oracle and, on one case, its Pallas kernel in interpret
  mode, within 1e-4·max(1, max|ref|) (the two sides sum in other orders,
  nothing more): pages of 16, 64 and 128 keys, head_dim 128 and the
  other widths the kernel is built for (32, 64, 80), shared and per-batch
  scales, a row with no items, pad items;
* the exact mode (``exact=True``, the card's arithmetic) against an
  independent numpy float64 computation of the pre-fold, bit for bit, and
  against the float32 mode within 1e-5·max|ref|;
* :func:`work_plan` at C = 1 on page-only descriptors against its rules
  written out, then a numpy run of the kernel's algorithm over its jobs:
  every output row written once, equal bit for bit to the exact plain op.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JR
from repro_torch.kernels import paged_attention as PA
from repro_torch.serving.kv_cache import build_work_queue
from test_torch_exact_combine import _direct_plan, _np_combine

F32 = np.float32
J_K8 = jax.jit(JR.paged_kv4_decode_attention_wq_ref)

CASES = [  # (seed, ps, hq, hkv, lengths, per-batch scales)
    (1, 16, 8, 2, [40, 0, 17, 183], False),    # a row with no items; 12 items
    (2, 64, 4, 1, [1, 63, 64, 65, 487], True),
    (3, 128, 16, 2, [300, 129, 0, 128], True),  # pages of 128 keys
    (4, 128, 8, 8, [1, 700], False),            # G = 1
]
# the other head_dims the kernels are built for (+ d): the smoke configs'
# 32, the TP test model's 64, Zamba2's 80
HEAD_DIM_CASES = [
    (6, 16, 8, 2, [40, 0, 17, 183], False, 32),
    (7, 64, 4, 1, [1, 63, 64, 65, 487], True, 64),
    (8, 16, 16, 2, [300, 129, 0, 128], True, 80),
    (9, 128, 8, 8, [1, 700], False, 32),        # G = 1
]


def _case(seed, ps, hq, hkv, lengths, per_batch, d=128):
    """Seeded K8 inputs (numpy): pages scattered over the pool, bf16-valued
    queries, descriptors over real pages padded with count-0 items."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    need = [-(-n // ps) for n in lengths]
    num_pages = sum(need) + 2
    tbl = np.full((b, max(need) + 1), -1, np.int32)
    perm = rng.permutation(num_pages)
    i = 0
    for bi, npg in enumerate(need):
        tbl[bi, :npg] = perm[i:i + npg]
        i += npg
    kp, vp = [rng.integers(0, 256, (num_pages, ps, hkv, d // 2))
              .astype(np.uint8) for _ in range(2)]
    lead = (b,) if per_batch else ()
    ks, kz, vs, vz = [rng.uniform(lo, hi, lead + (hkv, 1, d)).astype(F32)
                      for lo, hi in ((0.05, 0.2), (6, 9), (0.05, 0.2),
                                     (6, 9))]
    q = rng.normal(size=(b, hq, d)).astype(F32)
    q = (q.view(np.uint32) & np.uint32(0xFFFF0000)).view(F32)
    desc = build_work_queue(tbl, lengths, ps, hkv)
    return q, kp, ks, kz, vp, vs, vz, desc


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("seed,ps,hq,hkv,lengths,per_batch", CASES)
def test_decode_wq_f32_matches_reference(seed, ps, hq, hkv, lengths,
                                         per_batch):
    """The plain version's float32 mode against the reference's oracle;
    the row with no items too (−s_v·z_v on both sides)."""
    _f32_matches_reference(_case(seed, ps, hq, hkv, lengths, per_batch),
                           hq, hkv, lengths)


@pytest.mark.parametrize("seed,ps,hq,hkv,lengths,per_batch,d",
                         HEAD_DIM_CASES)
def test_decode_wq_f32_matches_reference_at_head_dims(seed, ps, hq, hkv,
                                                      lengths, per_batch, d):
    """As above at head_dim 32, 64 and 80 (packed rows of 16, 32 and 40
    bytes)."""
    _f32_matches_reference(_case(seed, ps, hq, hkv, lengths, per_batch, d),
                           hq, hkv, lengths)


def _f32_matches_reference(args, hq, hkv, lengths):
    d = args[0].shape[-1]
    assert (args[-1][:, 2] == 0).any()                # pad items present
    want = np.asarray(J_K8(*[jnp.asarray(a) for a in args]))
    got = PA.paged_kv4_decode_attention_wq_ref(*[_t(a) for a in args])
    _close(got.numpy(), want)
    for bi, n in enumerate(lengths):
        if n == 0:                      # no items: the empty combine's affine
            vs, vz = (np.broadcast_to(x, (len(lengths), hkv, 1, d))[bi]
                      for x in args[5:7])
            empty = np.repeat(F32(0) * vs - vs * vz, hq // hkv, 1)
            np.testing.assert_array_equal(got[bi].numpy(),
                                          empty.reshape(hq, d))


def test_decode_wq_ps128_matches_pallas_interpret():
    """Pages of 128 keys, more than the first work-queue decode kernel
    took, through the reference's Pallas kernel in interpret mode."""
    args = _case(5, 128, 8, 2, [200, 0, 129], True)
    want = JOPS.paged_kv4_decode_attention_wq(
        *[jnp.asarray(a) for a in args], impl="pallas")
    _close(PA.paged_kv4_decode_attention_wq_ref(
        *[_t(a) for a in args]).numpy(), want)


@pytest.mark.parametrize("seed,ps,hq,hkv,lengths,per_batch,d",
                         [c + (128,) for c in CASES] + HEAD_DIM_CASES)
def test_exact_decode_prefold_matches_numpy(seed, ps, hq, hkv, lengths,
                                            per_batch, d):
    """q̃ = (q·s_k)·(1/√D) in two float32 roundings and c = f32(Σ_f64
    q̃·z_k), bit for bit, at every head_dim the kernels are built for."""
    q, _, ks, kz, *_ = _case(seed, ps, hq, hkv, lengths, per_batch, d)
    b = q.shape[0]
    g = hq // hkv
    qt2, c2 = PA.decode_prefold(_t(q), _t(ks), _t(kz), hkv, exact=True)
    ksb = np.broadcast_to(ks, (b, hkv, 1, d))
    kzb = np.broadcast_to(kz, (b, hkv, 1, d))
    qt = (q.reshape(b, hkv, g, d) * ksb).astype(F32) * (F32(1)
                                                        / np.sqrt(F32(d)))
    c = (qt.astype(np.float64) * kzb.astype(np.float64)).sum(-1)
    np.testing.assert_array_equal(qt2.numpy(), qt.reshape(b * hkv, g, d))
    np.testing.assert_array_equal(c2.numpy(),
                                  c.astype(F32).reshape(b * hkv, g, 1))


@pytest.mark.parametrize("seed,ps,hq,hkv,lengths,per_batch", CASES)
def test_exact_decode_op_close_to_f32_op(seed, ps, hq, hkv, lengths,
                                         per_batch):
    """The exact op differs from the float32 one (the CPU default) only by
    float32 summation order."""
    args = [_t(a) for a in _case(seed, ps, hq, hkv, lengths, per_batch)]
    exact = PA.paged_kv4_decode_attention_wq_ref(*args, exact=True)
    f32 = PA.paged_kv4_decode_attention_wq_ref(*args)
    assert torch.equal(f32, PA.paged_kv4_decode_attention_wq_ref(
        *args, exact=False))
    err = float((exact - f32).abs().max())
    assert err <= 1e-5 * float(f32.abs().max()), err


@pytest.mark.parametrize("seed,ps,hq,hkv,lengths,per_batch", CASES)
def test_decode_work_plan_runs_the_kernels_algorithm(seed, ps, hq, hkv,
                                                     lengths, per_batch):
    """work_plan at C = 1 on page items only: 8-row tiles, one compute job
    per real item grouped by row in descriptor order, pad items dropped,
    one zero job per row with no items. Run over those jobs in numpy as
    the kernel runs (each row's last job combines its items' exact
    partials, then the V affine; a zero job writes −s_v·z_v), every output
    row is written once and equals the exact plain op bit for bit."""
    _runs_the_kernels_algorithm(
        _case(seed, ps, hq, hkv, lengths, per_batch), hq, hkv, lengths)


@pytest.mark.parametrize("seed,ps,hq,hkv,lengths,per_batch,d",
                         HEAD_DIM_CASES)
def test_decode_work_plan_runs_the_kernels_algorithm_at_head_dims(
        seed, ps, hq, hkv, lengths, per_batch, d):
    """As above at head_dim 32, 64 and 80."""
    _runs_the_kernels_algorithm(
        _case(seed, ps, hq, hkv, lengths, per_batch, d), hq, hkv, lengths)


def _runs_the_kernels_algorithm(args, hq, hkv, lengths):
    q, kp, ks, kz, vp, vs, vz, desc = args
    b, _, d = q.shape
    g = hq // hkv
    plan = PA.work_plan(desc, b * hkv, 1, g, "cpu")
    rows, jobs, ncompute = _direct_plan(desc, b * hkv, 1, g)
    assert (plan.rows, plan.ncompute, plan.cg) == (8, ncompute, g) == (
        rows, int((desc[:, 2] > 0).sum()), g)
    np.testing.assert_array_equal(plan.jobs.numpy(), jobs)
    assert len(jobs) - ncompute == hkv * lengths.count(0)

    targs = [_t(a) for a in args]
    want = PA.paged_kv4_decode_attention_wq_ref(*targs, plan=plan,
                                                exact=True).numpy()
    qt2, c2 = PA.decode_prefold(targs[0], targs[2], targs[3], hkv,
                                exact=True)
    acc, l, m = (x.numpy() for x in PA.paged_kv4_decode_partials_ref(
        targs[-1], qt2, c2, targs[1], targs[4], exact=True))
    vsb = np.broadcast_to(vs, (b, hkv, 1, d)).reshape(b * hkv, 1, d)
    vzb = np.broadcast_to(vz, (b, hkv, 1, d)).reshape(b * hkv, 1, d)
    out = np.full((b * hkv, g, d), np.nan, F32)
    writes = np.zeros(b * hkv, int)
    for j in range(ncompute):
        item, tile, first, cnt = jobs[j]
        assert tile == 0
        if j != first + cnt - 1:       # the row's last job combines
            continue
        its = jobs[first:first + cnt, 0]
        assert (np.diff(its) > 0).all()                # descriptor order
        row = desc[its[0], 0]
        comb = _np_combine(acc[its], l[its], m[its])
        out[row] = vsb[row] * comb - vsb[row] * vzb[row]
        writes[row] += 1
    for _, t0, row, t1 in jobs[ncompute:]:
        assert (t0, t1) == (0, 1)
        out[row] = vsb[row] * F32(0) - vsb[row] * vzb[row]
        writes[row] += 1
    assert (writes == 1).all()
    np.testing.assert_array_equal(out.reshape(b, hq, d), want)
