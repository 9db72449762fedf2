"""Paged KV4 attention straight off the int4 page pools, under the
reference's two grid schedules: the CUDA kernels and their plain versions.

Kernels (each replaces the ``repro/kernels/paged_attention.py`` function
of the same name; see the source notes for what bounds each on the H100
and how its design answers that):

* ``paged_kv4_prefill_attention_wq`` (K9, ``csrc/paged_attention.cu``) —
  work-queue chunked prefill, the whole op in one launch: one block per
  (descriptor item, query-row tile) folds its queries, computes the item's
  flash partial on the f64 tensor cores and leaves it in a scratch buffer;
  the last block of each (row, tile) to arrive combines the row's
  partials (:func:`work_plan`, built on the host once per step);
* ``paged_kv4_prefill_attention`` (K7) and ``paged_kv4_decode_attention``
  (K6) — the dense schedule, one kernel for both
  (``csrc/dense_attention.cuh``): each (row, query tile) scores its keys
  once on the f64 tensor cores, the keys of a row split across a
  thread-block cluster (:func:`kv4_attention.dense_plan`); one launch,
  no glue;
* ``paged_kv4_decode_attention_wq`` (K8, ``csrc/paged_attention.cu``) —
  work-queue decode, the whole op in one launch of K9's kernel at C = 1
  (its ``DECODE`` form): one block per page item folds the row's queries
  and leaves a nibble-space partial in scratch; the last block of each
  row combines them and applies the V affine after the combine
  (:func:`work_plan` at C = 1, built by the engine once per decode
  forward).

The host flattens a work-queue batch into ``[W, 4]`` int32 descriptors
``(row, phys_page, count, kind)`` (``serving.kv_cache.build_work_queue``).
Each item yields one flash partial ``(acc, l, m)``: kind 0 is one int4
history page, kind 1 the row's causal in-flight fp chunk. A speculating
decode row (a verify chunk whose KV is already in its pages) reads its
history as its decode steps would: kind ``KIND_CAUSAL + (ctx − page
start)`` is a page whose keys query i sees only below position ctx + i,
and kind 2 is the chunk item in which each query sees its own key alone
(``serving.kv_cache.build_work_queue(verify=...)``), so query i of the
chunk computes what the plain decode step at ctx + i computes.
:func:`combine_work_partials` merges the partials per row:

    M_r = max_i m_i,   out_r = Σ_i e^{m_i−M_r}·acc_i / Σ_i e^{m_i−M_r}·l_i

Padding items carry a sentinel row ``≥ num_rows`` and ``count = 0``; the
combine drops them. Dense block tables hold −1 for unmapped pages: every
version clamps them to page 0, which is never read for its values (it
lies at or past the row's length).

Exact mode (``kv4_attention``): on a CUDA tensor every plain version here
sums in float64 and rounds once, as its kernel does, so the two agree bit
for bit; each K8, K9 and combine piece takes ``exact`` to choose the mode
explicitly (default: the input's device), so the CPU tests can run the
card's arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import quantizer as Q
from repro_torch.kernels import _build
from repro_torch.kernels import kv4_attention as KA

NEG_INF = -1e30
KIND_PAGE, KIND_CHUNK, KIND_SELF = 0, 1, 2    # descriptor kinds
KIND_CAUSAL = 1 << 16     # + (ctx − page start): a verify row's causal
#                           page; every kind past KIND_SELF is one

__all__ = ["NEG_INF", "KIND_PAGE", "KIND_CHUNK", "KIND_SELF", "KIND_CAUSAL",
           "CombinePlan", "combine_plan", "combine_work_partials",
           "WorkPlan", "work_plan", "prefold", "paged_kv4_partials_ref",
           "paged_kv4_prefill_attention_wq_ref",
           "paged_kv4_prefill_attention_wq",
           "paged_kv4_prefill_attention_ref", "paged_kv4_prefill_attention",
           "paged_kv4_decode_attention_ref", "paged_kv4_decode_attention",
           "decode_prefold", "paged_kv4_decode_partials_ref",
           "paged_kv4_decode_attention_wq_ref",
           "paged_kv4_decode_attention_wq"]


def _inv_sqrt(d: int) -> float:
    """1/√d rounded as the reference computes it: in float32."""
    return float(torch.tensor(float(d), dtype=torch.float32).sqrt()
                 .reciprocal())


class CombinePlan(NamedTuple):
    """Where each item's partial goes in the combine: ``order`` sorts the
    items by row (stable), ``seg`` is each sorted item's row
    (``num_rows`` = dropped), ``pos`` its slot within that row, ``kmax``
    the most items any row has."""
    order: torch.Tensor
    seg: torch.Tensor
    pos: torch.Tensor
    kmax: int


def combine_plan(rows, num_rows: int, device) -> CombinePlan:
    """The combine's plan from the descriptor rows (numpy ``[W]``), worked
    out on the host: the engine builds it once per step from the
    descriptors it already holds, so no layer waits for the card."""
    rows = np.minimum(np.asarray(rows, np.int64), num_rows)
    order = np.argsort(rows, kind="stable")
    seg = rows[order]
    start = np.searchsorted(seg, np.arange(num_rows + 1))
    pos = np.where(seg < num_rows, np.arange(seg.size) - start[seg], 0)
    idx = torch.from_numpy(np.stack([order, seg, pos])).to(device)
    return CombinePlan(idx[0], idx[1], idx[2], int(pos.max(initial=0)) + 1)


def combine_work_partials(acc, l, m, rows, num_rows: int,
                          plan: Optional[CombinePlan] = None,
                          exact: Optional[bool] = None) -> torch.Tensor:
    """Split-KV log-sum-exp combine of per-item partials.

    acc ``[W, R, D]``, l/m ``[W, R, 1]``, rows ``[W]`` segment ids (ids
    ``≥ num_rows`` are padding and dropped) → ``[num_rows, R, D]``; rows
    with no items come back 0. Without ``plan`` (:func:`combine_plan` of
    the same rows) the rows are read back to the host once.

    Deterministic: each row's items are summed in descriptor order, one
    add at a time (the order of the reference's segment sum), instead of
    with atomics, so two runs on the card agree bit for bit. Exact mode:
    w = f32(exp_f64(m − M)), and Σ w·acc and Σ w·l are float64 sums of
    the exact products, each rounded once; the division stays f32."""
    dev = acc.device
    ex = KA.exact(acc) if exact is None else exact
    if plan is None:
        plan = combine_plan(rows.cpu().numpy(), num_rows, dev)
    order, seg = plan.order, plan.seg
    m = m[order]
    mmax = torch.full((num_rows + 1,) + tuple(m.shape[1:]), float("-inf"),
                      dtype=m.dtype, device=dev)
    mmax.scatter_reduce_(0, seg.view(-1, *[1] * (m.ndim - 1)).expand_as(m),
                         m, "amax")
    # rows with no items keep -inf; clamp to the finite NEG_INF so a
    # fully-masked partial weighs exp(0) instead of exp(+inf)
    mmax = mmax.clamp_min(NEG_INF)
    w = KA.exp(m - mmax[seg], ex)

    def segment_sum(x):
        # dropped items all land on slot 0 of a scratch row num_rows, one
        # row past the output
        buf = torch.zeros((num_rows + 1, plan.kmax) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=dev)
        buf[seg, plan.pos] = x
        out = buf[:num_rows, 0]
        for k in range(1, plan.kmax):
            out = out + buf[:num_rows, k]
        return out

    if ex:
        w = w.double()
        return (segment_sum(acc[order].double() * w).float()
                / segment_sum(l[order].double() * w).float().clamp_min(1e-30))
    return (segment_sum(acc[order] * w)
            / segment_sum(l[order] * w).clamp_min(1e-30))


def prefold(q, k_new, v_new, k_scale, k_zero, v_scale, v_zero,
            exact: Optional[bool] = None):
    """Affine pre-fold of the plain version (reference ``:648-661``).

    → qt2 = (q·s_k)·(1/√D) and c2 = Σ qt·z_k (history pages), qs2 =
    q·(1/√D) (fp chunk), all ``[B·Hkv, C·G, ·]``; kn2/vn2 ``[B·Hkv, C, D]``
    f32; v scale/zero ``[Hkv, D]``. Exact mode: c2 a float64 sum of the
    exact products, rounded once."""
    ex = KA.exact(q) if exact is None else exact
    b, c, hq, d = q.shape
    hkv = k_new.shape[2]
    g = hq // hkv
    nrows = b * hkv
    sm = _inv_sqrt(d)
    qg = q.reshape(b, c, hkv, g, d).float().movedim(1, 2)   # [B,Hkv,C,G,D]
    ksb = k_scale.expand(hkv, 1, d).reshape(1, hkv, 1, 1, d)
    kzb = k_zero.expand(hkv, 1, d).reshape(1, hkv, 1, 1, d)
    qt = qg * ksb * sm
    cterm = (KA.row_sum(qt.double() * kzb.double(), True) if ex
             else (qt * kzb).sum(-1, keepdim=True))
    return (qt.reshape(nrows, c * g, d).contiguous(),
            cterm.reshape(nrows, c * g, 1).contiguous(),
            (qg * sm).reshape(nrows, c * g, d).contiguous(),
            k_new.float().transpose(1, 2).reshape(nrows, c, d).contiguous(),
            v_new.float().transpose(1, 2).reshape(nrows, c, d).contiguous(),
            v_scale.expand(hkv, 1, d).reshape(hkv, d).float().contiguous(),
            v_zero.expand(hkv, 1, d).reshape(hkv, d).float().contiguous())


def paged_kv4_partials_ref(desc, qt2, c2, qs2, kn2, vn2, vs2, vz2, k_pool,
                           v_pool, g: int, exact: Optional[bool] = None):
    """Every item's partial for every kind, selected by ``kind`` (reference
    ``ref.py:341-395``; the verify row's causal page and own-key chunk
    kinds are the port's), on pre-folded inputs (:func:`prefold`) → acc
    ``[W, C·G, D]``, l and m ``[W, C·G, 1]``. Exact mode: the contractions
    and Σp in float64 rounded once, p = f32(exp_f64(s − m)); the V affine
    ``acc·s_v − l·(s_v·z_v)`` in f32 as before."""
    ex = KA.exact(qt2) if exact is None else exact
    nrows, cg, d = qt2.shape
    c = kn2.shape[1]
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    desc = desc.long()
    rcl = desc[:, 0].clamp(max=nrows - 1)
    heads = rcl % hkv
    counts = desc[:, 2][:, None, None]
    kind = desc[:, 3][:, None, None]
    sel = (kind == KIND_CHUNK) | (kind == KIND_SELF)
    # a causal page's keys below ctx + qi (qi the query's chunk position)
    off = torch.where(kind > KIND_SELF, kind - KIND_CAUSAL, ps)
    qi = (torch.arange(cg, device=desc.device) // g)[None, :, None]
    vsb, vzb = vs2[heads][:, None, :], vz2[heads][:, None, :]

    nk = Q.unpack_kv_nibbles(k_pool[desc[:, 1], :, heads])     # [W, ps, D]
    nv = Q.unpack_kv_nibbles(v_pool[desc[:, 1], :, heads])
    s_h = KA.contract("wgd,wpd->wgp", qt2[rcl], nk, ex) - c2[rcl]
    pos = torch.arange(ps, device=desc.device)[None, None, :]
    s_h = torch.where((pos < counts) & (pos < qi + off), s_h, NEG_INF)
    m_h = s_h.amax(-1, keepdim=True)
    p_h = KA.exp(s_h - m_h, ex)
    l_h = KA.row_sum(p_h, ex)
    pv = KA.contract("wgp,wpd->wgd", p_h, nv, ex)
    acc_h = pv * vsb - l_h * (vsb * vzb)

    s_c = KA.contract("wgd,wcd->wgc", qs2[rcl], kn2[rcl], ex)
    kj = torch.arange(c, device=desc.device)[None, None, :]
    seen = torch.where(kind == KIND_SELF, kj == qi, kj <= qi)
    s_c = torch.where(seen & (kj < counts), s_c, NEG_INF)
    m_c = s_c.amax(-1, keepdim=True)
    p_c = KA.exp(s_c - m_c, ex)
    l_c = KA.row_sum(p_c, ex)
    acc_c = KA.contract("wgc,wcd->wgd", p_c, vn2[rcl], ex)
    return (torch.where(sel, acc_c, acc_h), torch.where(sel, l_c, l_h),
            torch.where(sel, m_c, m_h))


def paged_kv4_prefill_attention_wq_ref(q, k_new, v_new, k_pool, k_scale,
                                       k_zero, v_pool, v_scale, v_zero,
                                       work_items, plan=None,
                                       exact: Optional[bool] = None
                                       ) -> torch.Tensor:
    """Plain version: q ``[B, C, Hq, D]``, in-flight k/v ``[B, C, Hkv, D]``,
    pools ``[P, ps, Hkv, D/2]`` uint8, scales/zeros ``[Hkv, 1, D]``,
    descriptors ``[W, 4]``, optional :class:`CombinePlan` (or
    :class:`WorkPlan`) of their rows → f32 ``[B, C, Hq, D]``: pre-fold →
    per-item partials → combine. Rows past a row's q_len are padding
    garbage; the caller masks them."""
    b, c, hq, d = q.shape
    hkv = k_pool.shape[2]
    ex = KA.exact(q) if exact is None else exact
    folded = prefold(q, k_new, v_new, k_scale, k_zero, v_scale, v_zero, ex)
    acc, l, m = paged_kv4_partials_ref(work_items, *folded, k_pool, v_pool,
                                       hq // hkv, ex)
    if isinstance(plan, WorkPlan):
        plan = plan.combine
    out = combine_work_partials(acc, l, m, work_items[:, 0], b * hkv, plan,
                                ex)
    out = out.reshape(b, hkv, c, hq // hkv, d).movedim(2, 1)
    return out.reshape(b, c, hq, d)


class WorkPlan(NamedTuple):
    """How the K9 kernel is launched for one descriptor array: ``jobs``
    ``[J, 4]`` int32 on the device — first the ``ncompute`` compute jobs
    ``(item, tile, first, count)``, ordered by (row, tile, descriptor
    order), ``first`` the first job of the item's (row, tile) group (its
    partials' first scratch slot and its arrival counter) and ``count``
    the row's items; then zero jobs ``(−1, first tile, row, end tile)`` for
    the output rows no item covers — over query-row tiles of ``rows``
    rows of a ``cg`` = C·G row block; ``combine`` the plain version's
    :class:`CombinePlan` of the same descriptors."""
    jobs: torch.Tensor
    rows: int
    ncompute: int
    cg: int
    combine: CombinePlan


WQ_ZERO_ROWS = 256       # query rows one zero job clears


def wq_fixed_smem(d: int) -> int:
    """Shared bytes of the work-queue kernel besides the scores at head_dim
    d (csrc ``wq_fixed``: 78,608 at 128): the f64 K/V tile, two packed
    tiles, the scales, the row reductions and the arrival flag."""
    return (KA.DENSE_KEY_TILE * (d + 4) * 8 + 2 * KA.DENSE_KEY_TILE * (d // 2)
            + 4 * d * 4 + 64 * 4 + 4 * 32 * 4 + 16)


def work_plan(desc, num_rows: int, c: int, g: int, device) -> WorkPlan:
    """K9's jobs for the descriptors ``desc`` (numpy ``[W, 4]``), worked out
    on the host from the descriptors alone: the engine builds it once per
    step, so no layer waits for the card. Items with ``count ≤ 0`` or a
    row outside ``[0, num_rows)`` are dropped. A row's valid query rows
    are its chunk item's ``min(count, C)·G`` (all C·G if it has none); the
    tile height is the smallest of 8, 16, 32 that holds the largest, and
    a row gets compute jobs for the tiles its valid rows reach."""
    desc = np.asarray(desc, np.int64).reshape(-1, 4)
    row, cnt, kind = desc[:, 0], desc[:, 2], desc[:, 3]
    cg = c * g
    items = np.nonzero((cnt > 0) & (row >= 0) & (row < num_rows))[0]
    items = items[np.argsort(row[items], kind="stable")]
    per_row = np.bincount(row[items], minlength=num_rows)[:num_rows]
    qrows = np.where(per_row > 0, cg, 0)
    chunk = items[(kind[items] == KIND_CHUNK) | (kind[items] == KIND_SELF)]
    qrows[row[chunk]] = np.minimum(cnt[chunk], c) * g
    top = int(qrows.max(initial=0))
    rows = 8 if top <= 8 else 16 if top <= 16 else 32
    ntile = -(-cg // rows)
    tiles = -(-qrows // rows)
    n = tiles * per_row                          # compute jobs of each row
    base = np.cumsum(n) - n
    k = np.repeat(per_row, n)
    local = np.arange(int(n.sum())) - np.repeat(base, n)
    tile = local // np.maximum(k, 1)
    start = np.cumsum(per_row) - per_row         # the row's first item
    compute = np.stack([items[np.repeat(start, n) + local % np.maximum(k, 1)],
                        tile, np.repeat(base, n) + tile * k, k], 1)
    zt = max(1, WQ_ZERO_ROWS // rows)            # tiles per zero job
    nz = -(-(ntile - tiles) // zt)
    z0 = (np.repeat(tiles, nz)
          + (np.arange(int(nz.sum())) - np.repeat(np.cumsum(nz) - nz, nz))
          * zt)
    zero = np.stack([np.full_like(z0, -1), z0,
                     np.repeat(np.arange(num_rows), nz),
                     np.minimum(z0 + zt, ntile)], 1)
    jobs = np.concatenate([compute, zero]).astype(np.int32).reshape(-1, 4)
    return WorkPlan(torch.from_numpy(jobs).to(device), rows, len(compute),
                    cg, combine_plan(desc[:, 0], num_rows, device))


_ARRIVE: dict = {}


def _arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """K9's per-(row, tile) arrival counters on ``device``: zero between
    launches (the last block of each group resets its own), so one
    zeroed buffer serves every launch on the device's stream; it grows
    when a plan needs more."""
    buf = _ARRIVE.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _ARRIVE[device] = buf
    return buf


def _wq_buffers(plan: WorkPlan, keys: int, d: int, device):
    """The work-queue kernel's buffers for ``plan``, whose jobs each score
    at most ``keys`` keys → (score row stride in floats, dynamic shared
    bytes, the scores' scratch buffer — None while they fit in shared
    memory — and the partials' buffer, f32 [compute jobs][rows][D + 2])."""
    rows, nc = plan.rows, plan.ncompute
    sstride = KA.round_up(keys, KA.DENSE_KEY_TILE) + 8
    fixed = wq_fixed_smem(d)
    smem = fixed + rows * sstride * 4
    scratch = None
    if smem > KA.DENSE_SMEM_MAX:
        smem = fixed
        scratch = torch.empty(nc * rows * sstride, dtype=torch.float32,
                              device=device)
    part = torch.empty(nc * rows * (d + 2), dtype=torch.float32,
                       device=device)
    return sstride, smem, scratch, part


def paged_kv4_prefill_attention_wq(q, k_new, v_new, k_pool, k_scale, k_zero,
                                   v_pool, v_scale, v_zero, work_items,
                                   plan=None) -> torch.Tensor:
    """The K9 kernel: the whole op — pre-fold, per-item partials and
    combine — in one launch. Same arguments and result as the plain
    version (bit for bit on the card for the rows below each row's
    q_len·G; the rest of the output is finite: combined garbage or 0).
    ``plan`` is the :class:`WorkPlan` of these descriptors (:func:`work_plan`,
    built on the host); without one (or with a :class:`CombinePlan`) the
    descriptors are read back to the host to build it. q f32 or bf16; a
    head_dim of ``kv4_attention.HEAD_DIMS``; the scores of one job stay in
    shared memory up to max(ps, C) = 1,152 keys at 32-row tiles and D =
    128, beyond that in a scratch buffer. Launches on the op's stream; the arrival counters are shared,
    so two launches must not run at once on different streams."""
    b, c, hq, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    g = hq // hkv
    KA.check_kv4_inputs(q, k_pool, v_pool, d,
                        "paged_kv4_prefill_attention_wq")
    dev = q.device
    if not isinstance(plan, WorkPlan) or plan.cg != c * g:
        plan = work_plan(work_items.cpu().numpy(), b * hkv, c, g, dev)
    ks, kz, vs, vz = _head_scales((k_scale, k_zero, v_scale, v_zero), hkv, d)
    desc = work_items.to(device=dev, dtype=torch.int32).contiguous()
    q_bf16 = q.dtype == torch.bfloat16
    q = (q if q_bf16 else q.float()).contiguous()
    k_new = k_new.float().contiguous()
    v_new = v_new.float().contiguous()
    sstride, smem, scratch, part = _wq_buffers(plan, max(ps, c), d, dev)
    out = torch.empty((b, c, hq, d), dtype=torch.float32, device=dev)
    _build.call("paged_attention", "paged_kv4_prefill_wq", dev, desc,
                plan.jobs, plan.jobs.shape[0], q, int(q_bf16), k_new, v_new,
                ks, kz, vs, vz, k_pool, v_pool, out, part,
                _arrival_counters(dev, plan.ncompute), scratch, c, g, hkv,
                ps, d, plan.rows, sstride, smem)
    paged_kv4_prefill_attention_wq.launches += 1
    return out


paged_kv4_prefill_attention_wq.launches = 0


# ------------------------------------------------- dense chunked prefill (K7)

def _bcast(s, b: int, hkv: int, d: int):
    return torch.broadcast_to(s, (b, hkv, 1, d))


def paged_kv4_prefill_attention_ref(q, k_new, v_new, k_pool, k_scale, k_zero,
                                    v_pool, v_scale, v_zero, block_tables,
                                    ctx_lens, q_lens,
                                    compute_dtype=torch.float32):
    """Plain version (reference ``ref.paged_kv4_prefill_attention_ref``):
    query i of row b attends over its int4 history [0, ctx_lens[b]),
    gathered through the block table (−1 → page 0) and dequantized, and
    the causal fp prefix of its chunk, keys j ≤ i, j < q_lens[b]. q
    ``[B, C, Hq, D]``, k/v_new ``[B, C, Hkv, D]``, tables ``[B, NP]`` →
    f32 ``[B, C, Hq, D]``; rows past q_len are finite garbage. Exact mode
    on the card (see ``kv4_attention``)."""
    b, c, hq, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    g = hq // hkv
    npages = block_tables.shape[1]
    t_hist = npages * ps
    dev = q.device
    tables = block_tables.long().clamp_min(0)

    def operand(x):
        return x.to(compute_dtype).float()

    def gather_deq(pool, scale, zero):
        flat = pool[tables].reshape(b, t_hist, hkv, d // 2).transpose(1, 2)
        return operand(Q.dequantize_kv_channelwise(
            flat, _bcast(scale, b, hkv, d), _bcast(zero, b, hkv, d)))

    keys = torch.cat([gather_deq(k_pool, k_scale, k_zero),
                      operand(k_new.transpose(1, 2))], 2)  # [B, Hkv, T, D]
    vals = torch.cat([gather_deq(v_pool, v_scale, v_zero),
                      operand(v_new.transpose(1, 2))], 2)
    qg = operand(q.reshape(b, c, hkv, g, d))
    ex = KA.exact(q)
    scores = (KA.contract("bchgd,bhtd->bhgct", qg, keys, ex)
              / KA.sqrt_d(d, dev))                        # [B, Hkv, G, C, T]
    tpos = torch.arange(t_hist + c, device=dev)
    ctx = ctx_lens.to(dev).long()
    ql = q_lens.to(dev).long()
    hist_valid = tpos[None, :] < ctx[:, None]                      # [B, T]
    j = tpos - t_hist
    i = torch.arange(c, device=dev)
    chunk_valid = ((j[None, None, :] <= i[None, :, None])
                   & (j[None, None, :] < ql[:, None, None]))       # [B, C, T]
    valid = torch.where((tpos < t_hist)[None, None, :],
                        hist_valid[:, None, :], chunk_valid)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    p = KA.softmax(scores, ex)
    out = KA.contract("bhgct,bhtd->bhgcd", operand(p), vals, ex)
    return out.movedim(3, 1).reshape(b, c, hq, d)


def _head_scales(scales, hkv: int, d: int):
    """[Hkv, 1, D] scale/zero tensors → contiguous f32 [Hkv, D]."""
    return [torch.broadcast_to(s, (hkv, 1, d)).reshape(hkv, d).float()
            .contiguous() for s in scales]


def paged_kv4_prefill_attention(q, k_new, v_new, k_pool, k_scale, k_zero,
                                v_pool, v_scale, v_zero, block_tables,
                                ctx_lens, q_lens) -> torch.Tensor:
    """The K7 kernel: same arguments and result as the plain version (bit
    for bit on the card), in one launch (:func:`kv4_attention.dense_plan`).
    A head_dim of ``kv4_attention.HEAD_DIMS``. Rows at or past ``q_len·G``
    come back 0."""
    b, c, hq, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    KA.check_kv4_inputs(q, k_pool, v_pool, d, "paged_kv4_prefill_attention")
    dev = q.device
    ks, kz, vs, vz = _head_scales((k_scale, k_zero, v_scale, v_zero), hkv, d)
    tables = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    q_bf16 = q.dtype == torch.bfloat16
    q = (q if q_bf16 else q.float()).contiguous()
    k_new = k_new.float().contiguous()
    v_new = v_new.float().contiguous()
    ctx = ctx_lens.to(device=dev, dtype=torch.int32).contiguous()
    ql = q_lens.to(device=dev, dtype=torch.int32).contiguous()
    plan = KA.dense_plan(b, c, hq // hkv, hkv, tables.shape[1], ps, d)
    scratch = (torch.empty(plan.scratch, dtype=torch.float32, device=dev)
               if plan.scratch else None)
    out = torch.empty((b, c, hq, d), dtype=torch.float32, device=dev)
    _build.call("paged_attention", "paged_kv4_prefill_dense", dev, q,
                int(q_bf16), k_new, v_new, ks, kz, vs, vz, k_pool, v_pool,
                tables, ctx, ql, out, scratch, b, c, hq // hkv, hkv,
                tables.shape[1], ps, d,
                plan.rows, plan.split, plan.sstride, plan.smem)
    paged_kv4_prefill_attention.launches += 1
    return out


paged_kv4_prefill_attention.launches = 0


# ------------------------------------------------------ dense decode (K6)

def paged_kv4_decode_attention_ref(q, k_pool, k_scale, k_zero, v_pool,
                                   v_scale, v_zero, block_tables, length,
                                   compute_dtype=torch.float32):
    """Plain version (reference ``ref.paged_kv4_decode_attention_ref``):
    gather each row's pages through the block table (−1 → page 0), then
    the contiguous flash-decode's plain version. q ``[B, Hq, D]``, tables
    ``[B, NP]``, length ``[B]`` → f32 ``[B, Hq, D]``."""
    b, hq, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    npages = block_tables.shape[1]
    tables = block_tables.long().clamp_min(0)

    def gather(pool):
        return pool[tables].reshape(b, npages * ps, hkv, d // 2).transpose(1, 2)

    return KA.kv4_decode_attention_ref(
        q, gather(k_pool), _bcast(k_scale, b, hkv, d), _bcast(k_zero, b, hkv, d),
        gather(v_pool), _bcast(v_scale, b, hkv, d), _bcast(v_zero, b, hkv, d),
        length, compute_dtype=compute_dtype)


def paged_kv4_decode_attention(q, k_pool, k_scale, k_zero, v_pool, v_scale,
                               v_zero, block_tables, length) -> torch.Tensor:
    """The K6 kernel: same arguments and result as the plain version (bit
    for bit on the card), in one launch of the dense kernel K7 runs, at
    C = 1 with no chunk keys (:func:`kv4_attention.dense_plan` sizes its
    cluster split). Any Hq/Hkv (rows of 8, 16 or 32 sized to G); q f32 or
    bf16; a head_dim of ``kv4_attention.HEAD_DIMS``."""
    b, hq, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    KA.check_kv4_inputs(q, k_pool, v_pool, d, "paged_kv4_decode_attention")
    dev = q.device
    (ks, kz, vs, vz), sb = KA.shared_scales(
        (k_scale, k_zero, v_scale, v_zero), b, hkv, d)
    tables = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    length = length.to(device=dev, dtype=torch.int32).contiguous()
    q_bf16 = q.dtype == torch.bfloat16
    q = (q if q_bf16 else q.float()).contiguous()
    plan = KA.dense_plan(b, 1, hq // hkv, hkv, tables.shape[1], ps, d)
    scratch = (torch.empty(plan.scratch, dtype=torch.float32, device=dev)
               if plan.scratch else None)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    _build.call("paged_decode", "paged_kv4_decode", dev, q, int(q_bf16),
                k_pool, v_pool, ks, kz, vs, vz, sb, tables, length, out,
                scratch, b, hkv, hq // hkv, tables.shape[1], ps, d,
                plan.rows, plan.split, plan.sstride, plan.smem)
    paged_kv4_decode_attention.launches += 1
    return out


paged_kv4_decode_attention.launches = 0


# ------------------------------------------------- work-queue decode (K8)

def decode_prefold(q, k_scale, k_zero, hkv: int,
                   exact: Optional[bool] = None):
    """q ``[B, Hq, D]`` → q̃ = (q·s_k)·(1/√D) ``[B·Hkv, G, D]`` and c = Σ
    q̃·z_k ``[B·Hkv, G, 1]`` (reference ``paged_attention.py:508-514``);
    scales ``[Hkv, 1, D]`` or per batch row ``[B, Hkv, 1, D]``. Exact mode:
    c a float64 sum of the exact products, rounded once."""
    ex = KA.exact(q) if exact is None else exact
    b, hq, d = q.shape
    g = hq // hkv
    qt = (q.reshape(b, hkv, g, d).float() * _bcast(k_scale, b, hkv, d)
          * _inv_sqrt(d))
    kz = _bcast(k_zero, b, hkv, d)
    c = (KA.row_sum(qt.double() * kz.double(), True) if ex
         else (qt * kz).sum(-1, keepdim=True))
    return (qt.reshape(b * hkv, g, d).contiguous(),
            c.reshape(b * hkv, g, 1).contiguous())


def paged_kv4_decode_partials_ref(desc, qt2, c2, k_pool, v_pool,
                                  exact: Optional[bool] = None):
    """Each item's partial over its page's first ``count`` keys, in nibble
    space (reference ``ref.py:287-307``), on pre-folded queries
    (:func:`decode_prefold`) → acc ``[W, G, D]``, l and m ``[W, G, 1]``.
    Exact mode: the contractions and Σp in float64 rounded once, p =
    f32(exp_f64(s − m))."""
    ex = KA.exact(qt2) if exact is None else exact
    nrows = qt2.shape[0]
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    desc = desc.long()
    rcl = desc[:, 0].clamp(max=nrows - 1)
    heads = rcl % hkv
    nk = Q.unpack_kv_nibbles(k_pool[desc[:, 1], :, heads])     # [W, ps, D]
    nv = Q.unpack_kv_nibbles(v_pool[desc[:, 1], :, heads])
    s = KA.contract("wgd,wpd->wgp", qt2[rcl], nk, ex) - c2[rcl]
    pos = torch.arange(ps, device=desc.device)[None, None, :]
    s = torch.where(pos < desc[:, 2][:, None, None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = KA.exp(s - m, ex)
    return KA.contract("wgp,wpd->wgd", p, nv, ex), KA.row_sum(p, ex), m


def paged_kv4_decode_attention_wq_ref(q, k_pool, k_scale, k_zero, v_pool,
                                      v_scale, v_zero, work_items, plan=None,
                                      exact: Optional[bool] = None
                                      ) -> torch.Tensor:
    """Plain version: q ``[B, Hq, D]``, descriptors ``[W, 4]`` (page items;
    ``kind`` is not read), scales/zeros ``[Hkv, 1, D]`` or ``[B, Hkv, 1,
    D]``, optional :class:`WorkPlan` or :class:`CombinePlan` of the
    descriptors → f32 ``[B, Hq, D]``: pre-fold → per-item partials →
    combine → s_v·comb − s_v·z_v (rows with no items: −s_v·z_v)."""
    b, hq, d = q.shape
    hkv = k_pool.shape[2]
    ex = KA.exact(q) if exact is None else exact
    qt2, c2 = decode_prefold(q, k_scale, k_zero, hkv, ex)
    acc, l, m = paged_kv4_decode_partials_ref(work_items, qt2, c2, k_pool,
                                              v_pool, ex)
    if isinstance(plan, WorkPlan):
        plan = plan.combine
    comb = combine_work_partials(acc, l, m, work_items[:, 0], b * hkv, plan,
                                 ex)
    sv = _bcast(v_scale, b, hkv, d)
    out = sv * comb.reshape(b, hkv, hq // hkv, d) - sv * _bcast(v_zero, b, hkv, d)
    return out.reshape(b, hq, d)


def paged_kv4_decode_attention_wq(q, k_pool, k_scale, k_zero, v_pool,
                                  v_scale, v_zero, work_items,
                                  plan=None) -> torch.Tensor:
    """The K8 kernel: the whole op — pre-fold, per-item partials, combine
    and V affine — in one launch of K9's kernel at C = 1. Same arguments
    and result as the plain version (bit for bit on the card, every output
    row). ``plan`` is the :class:`WorkPlan` of these descriptors at C = 1
    (:func:`work_plan`, built on the host); without one (or with a
    :class:`CombinePlan`) the descriptors are read back to build it. q f32
    or bf16; any Hq/Hkv; a head_dim of ``kv4_attention.HEAD_DIMS``; any
    page size (a job's scores stay in shared memory up to 4,736 keys at D =
    128, beyond that in a scratch buffer). The
    arrival counters are K9's (one launch at a time per device)."""
    b, hq, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    g = hq // hkv
    KA.check_kv4_inputs(q, k_pool, v_pool, d,
                        "paged_kv4_decode_attention_wq")
    dev = q.device
    if not isinstance(plan, WorkPlan) or plan.cg != g:
        plan = work_plan(work_items.cpu().numpy(), b * hkv, 1, g, dev)
    (ks, kz, vs, vz), sb = KA.shared_scales(
        (k_scale, k_zero, v_scale, v_zero), b, hkv, d)
    desc = work_items.to(device=dev, dtype=torch.int32).contiguous()
    q_bf16 = q.dtype == torch.bfloat16
    q = (q if q_bf16 else q.float()).contiguous()
    sstride, smem, scratch, part = _wq_buffers(plan, ps, d, dev)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    _build.call("paged_attention", "paged_kv4_decode_wq", dev, desc,
                plan.jobs, plan.jobs.shape[0], q, int(q_bf16), ks, kz, vs, vz,
                sb, k_pool, v_pool, out, part,
                _arrival_counters(dev, plan.ncompute), scratch, g, hkv, ps, d,
                plan.rows, sstride, smem)
    paged_kv4_decode_attention_wq.launches += 1
    return out


paged_kv4_decode_attention_wq.launches = 0
