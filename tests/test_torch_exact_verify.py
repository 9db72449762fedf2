"""A verify chunk computes what its decode steps compute (exact mode, CPU).

Speculative decode feeds a decode row and its k drafts to the work-queue
prefill op (K9) as one chunk of 1 + k queries at history ctx; the plain
decode step that later commits the same token at position ctx + i is K9
over a chunk of 1 at history ctx + i. On the card (exact mode) greedy
speculation is only speculation-off token for token if query i of the
chunk gives the decode step's output bit for bit. Here K9's plain version
runs with ``exact=True`` on the CPU, on pools that already hold the
chunk's int4 KV (the engine writes it before attention) and in-flight
keys fake-quantized as the engine feeds them: the chunk under
``build_work_queue(verify=...)`` is held ``torch.equal`` to the decode
step at every position, across page boundaries, G = 1 and 4, next to a
prompt-chunk row and q_len-0 padding rows. The descriptors of a batch
with no speculating row are held to be the same as without the option,
and the kernel's job plan to give a verify row the rows of its queries.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.serving import kv_cache as KVC

D = 128


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(seed, ctx, hq, hkv, ps, c, num_pages=24):
    """Pools with random history, a block table for one row of ctx + c
    positions, the chunk's k/v written into its pages (int4) and returned
    fake-quantized (the in-flight values), bf16-valued queries."""
    rng = np.random.default_rng(seed)
    need = -(-(ctx + c) // ps)
    tbl = np.full((1, need + 1), -1, np.int32)
    tbl[0, :need] = rng.permutation(num_pages)[:need]
    kp, vp = [_t(rng.integers(0, 256, (num_pages, ps, hkv, D // 2))
                 .astype(np.uint8)) for _ in range(2)]
    ks, kz, vs, vz = [_t(rng.uniform(lo, hi, (hkv, 1, D)).astype(np.float32))
                      for lo, hi in ((0.05, 0.2), (6, 9), (0.05, 0.2),
                                     (6, 9))]
    k, v = [_t((rng.normal(size=(1, c, hkv, D)) * 0.8).astype(np.float32))
            for _ in range(2)]
    kq, vq = KVC.quantize_kv_with(k, v, ks, kz, vs, vz)   # [1, Hkv, c, D/2]
    pos = ctx + np.arange(c)
    pages, offs = _t(tbl[0, pos // ps].astype(np.int64)), _t(pos % ps)
    kp[pages, offs] = kq[0].transpose(0, 1)
    vp[pages, offs] = vq[0].transpose(0, 1)
    kdq, vdq = KVC.qdq_kv_with(k, v, ks, kz, vs, vz)
    q = rng.normal(size=(1, c, hq, D)).astype(np.float32)
    q = _t((q.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32))
    return tbl, q, kdq, vdq, (kp, ks, kz, vp, vs, vz)


def _k9(q, kn, vn, pools, desc, exact=True):
    kp, ks, kz, vp, vs, vz = pools
    g = q.shape[2] // kp.shape[2]
    plan = PA.work_plan(desc, q.shape[0] * kp.shape[2], q.shape[1], g, "cpu")
    return PA.paged_kv4_prefill_attention_wq_ref(
        q, kn, vn, kp, ks, kz, vp, vs, vz, _t(desc), plan=plan, exact=exact)


@pytest.mark.parametrize("ctx,ps,hq,hkv,k", [
    (30, 16, 8, 2, 4),      # the chunk crosses a page boundary
    (29, 16, 8, 8, 4),      # G = 1; its last key opens a page
    (64, 16, 8, 2, 4),      # ctx on a page boundary: the chunk a page alone
    (45, 16, 8, 2, 20),     # a chunk longer than a page
    (100, 64, 8, 2, 3),     # the card's page size
])
def test_verify_position_equals_decode_step(ctx, ps, hq, hkv, k):
    """Query i of a 1 + k verify chunk at ctx is ``torch.equal`` to the
    decode step of the same token at ctx + i, every i."""
    c = 1 + k
    tbl, q, kdq, vdq, pools = _state(ctx + k, ctx, hq, hkv, ps, c)
    desc = KVC.build_work_queue(tbl, [ctx], ps, hkv, [c], verify=[True])
    chunk = _k9(q, kdq, vdq, pools, desc)
    for i in range(c):
        step = KVC.build_work_queue(tbl, [ctx + i], ps, hkv, [1])
        one = _k9(q[:, i:i + 1], kdq[:, i:i + 1], vdq[:, i:i + 1], pools,
                  step)
        assert torch.equal(chunk[0, i], one[0, 0]), (
            f"position {i}: max diff "
            f"{float((chunk[0, i] - one[0, 0]).abs().max())}")


def test_verify_row_in_a_ragged_batch():
    """The same holds for a verify row bucketed behind a prompt-chunk row
    (the reference's causal in-flight chunk) and q_len-0 padding rows,
    chunk length padded to 8; the prompt row is unchanged by the option."""
    ps, hq, hkv, ctx, c = 16, 8, 2, 30, 5
    tbl, q1, kdq, vdq, pools = _state(7, ctx, hq, hkv, ps, c)
    rng = np.random.default_rng(8)
    nb, cb = 4, 8
    tbl2 = np.full((2, tbl.shape[1]), -1, np.int32)
    used = set(tbl[0][tbl[0] >= 0].tolist())
    tbl2[0, :2] = [p for p in range(pools[0].shape[0]) if p not in used][:2]
    tbl2[1] = tbl[0]
    q, kn, vn = [_t(rng.normal(size=(nb, cb, h, D)).astype(np.float32))
                 for h in (hq, hkv, hkv)]
    q[1, :c], kn[1, :c], vn[1, :c] = q1[0], kdq[0], vdq[0]
    args = (tbl2, [20, ctx], ps, hkv, [3, c])
    base = KVC.build_work_queue(*args, pad_row=nb * hkv)
    desc = KVC.build_work_queue(*args, pad_row=nb * hkv, verify=[False, True])
    out = _k9(q, kn, vn, pools, desc)
    ref = _k9(q, kn, vn, pools, base)
    assert torch.equal(out[0, :3], ref[0, :3])
    for i in range(c):
        step = KVC.build_work_queue(tbl, [ctx + i], ps, hkv, [1])
        one = _k9(q1[:, i:i + 1], kdq[:, i:i + 1], vdq[:, i:i + 1], pools,
                  step)
        assert torch.equal(out[1, i], one[0, 0]), f"position {i}"


def test_spec_off_descriptors_unchanged():
    """No speculating row: the option builds the reference's descriptors;
    a verify row of one query (a plain decode row) needs no causal page."""
    tbl = np.arange(12, dtype=np.int32).reshape(2, 6)
    args = (tbl, [63, 70], 16, 2, [5, 1])
    base = KVC.build_work_queue(*args)
    assert np.array_equal(KVC.build_work_queue(*args, verify=[False, False]),
                          base)
    one = KVC.build_work_queue(tbl, [63, 70], 16, 2, [1, 1])
    ver = KVC.build_work_queue(tbl, [63, 70], 16, 2, [1, 1],
                               verify=[True, True])
    assert np.array_equal(ver[:, :3], one[:, :3])
    assert set(ver[:, 3].tolist()) <= {PA.KIND_PAGE, PA.KIND_SELF}


def test_work_plan_rows_of_a_verify_row():
    """The job plan reads a verify row's own-key chunk item like a chunk
    item: C·G rows of the 5-query chunk → 32-row tiles at G = 4, one tile,
    one compute job per item of the row."""
    tbl = np.arange(6, dtype=np.int32).reshape(1, 6)
    desc = KVC.build_work_queue(tbl, [30], 16, 1, [5], verify=[True])
    items = int((desc[:, 2] > 0).sum())
    plan = PA.work_plan(desc, 1, 8, 4, "cpu")
    assert plan.rows == 32 and plan.ncompute == items
    kinds = desc[desc[:, 2] > 0, 3]
    assert kinds[-1] == PA.KIND_SELF and (kinds[:-1] > PA.KIND_SELF).any()
