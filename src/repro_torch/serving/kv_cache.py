"""Paged KV4 cache: int4 page pools on the device, allocator on the host
(``repro/serving/kv_cache.py``).

Pools are ``[L, num_pages, page_size, Hkv, D/2]`` uint8 tensors (one K, one
V); byte j of a token's head holds channel j (low nibble) and channel
j + D/2 (high nibble), asymmetric per-channel quantization with static
calibrated scales/zeros ``[Hkv, 1, D]``. The engine writes the pools in
place each step.

Host side: block tables ``[max_seqs, max_pages_per_seq]`` int32 (-1 =
unmapped), refcounted pages, a chained-SHA-256 prefix index over full
prompt pages with a reclaimable LRU (optionally capped in bytes by
``reclaimable_max_bytes``: releasing past the cap evicts oldest-first;
``prefix_evicted_pages`` counts every eviction, by the cap or by
allocation pressure, and ``prefix_reclaimable_bytes`` the bytes the LRU
pins), and the Stream-K work-queue descriptors (:func:`build_work_queue`,
numpy).

The split-step baselines also write whole prompts (:meth:`write_prompt`)
and scatter a step's tokens at destinations resolved once per step
(:meth:`token_dests`, :meth:`scatter_tokens`), hand the dense schedule
block tables with unmapped entries clamped to page 0, and gather a decode
batch's pages contiguously (:meth:`gather_kv`, the gather baseline).
Speculative decode rolls a sequence's resident length back (or forward,
over accepted drafts) with :meth:`truncate_seq`. :meth:`snapshot_state`
and :meth:`restore_state` move the whole cache, pools included, in the
reference's JSON blob (journaled crash recovery). Under tensor
parallelism each rank's cache holds the pools and scales of its slice of
the kv heads (``mesh=``) beside the same host state as every other
rank; its snapshot gathers the slices, so the blob is the full cache's,
and a restore keeps the rank's slice of a full blob. The engine's
``FaultInjector`` rides along as ``faults``: the ``alloc_page`` point
in :meth:`_acquire_page`, ``append_kv`` in :meth:`token_dests_np`. On
the card an out-of-range index is a device-side assert, not JAX's silent
drop or clamp, so every table handed to the device is clamped first.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantizer import qdq_kv_with, quantize_kv_with
from repro_torch.kernels import paged_attention as PA
from repro_torch.layers.common import resolve_device
from repro_torch.parallel.mesh import host_all_gather
from repro_torch.serving.faults import InjectedFault

__all__ = ["PagedKV4Config", "PagedKV4Cache", "build_work_queue",
           "quantize_kv_with", "qdq_kv_with", "json_str"]


@dataclasses.dataclass(frozen=True)
class PagedKV4Config:
    num_pages: int
    page_size: int = 64
    max_seqs: int = 64
    max_pages_per_seq: int = 128
    reclaimable_max_bytes: Optional[int] = None  # byte cap on the prefix LRU


MIN_ITEMS = 8     # the smallest work-queue length (a power of two)


def build_work_queue(block_tables, ctx_lens, page_size: int,
                     num_kv_heads: int, q_lens=None,
                     pad_row: Optional[int] = None,
                     seq_ids=None, verify=None) -> np.ndarray:
    """Flatten a ragged batch into ``[W, 4]`` int32 descriptors ``(row,
    phys_page, count, kind)``: one item per (seq, kv head, real history
    page) — kind 0, count = valid tokens in the page — plus, with
    ``q_lens``, one in-flight chunk item per row with q_len > 0 (kind 1,
    count = q_len). Items are row-major (row = seq·Hkv + head). W is
    padded to a power of two ≥ ``MIN_ITEMS`` with ``count = 0`` items on
    the sentinel row ``pad_row`` (default B·Hkv).

    ``verify`` (bool ``[B]``, with ``q_lens``) marks speculating decode
    rows, whose chunk KV is already written to their pages: their page
    items cover the ctx + q_len − 1 positions the chunk's last query
    sees, each page that holds a chunk token with kind ``KIND_CAUSAL +
    (ctx − page start)`` (query i sees its keys below ctx + i), and their
    chunk item
    has kind ``KIND_SELF`` (each query its own key): query i then reads
    the same keys, split at the same pages, as the plain decode step at
    ctx + i (``kernels/paged_attention.py``)."""
    tables = np.atleast_2d(np.asarray(block_tables))
    ctx = np.atleast_1d(np.asarray(ctx_lens)).astype(np.int64)
    b, ps, hkv = ctx.shape[0], page_size, num_kv_heads
    ver = (np.zeros(b, bool) if verify is None
           else np.atleast_1d(np.asarray(verify, bool)))
    # positions the row's pages hold for its queries: a verify row's last
    # query reads the chunk's earlier tokens from the pages too
    hist = ctx + np.where(ver, np.atleast_1d(np.asarray(
        q_lens if q_lens is not None else np.zeros(b))).astype(np.int64)
        - 1, 0)
    npg = -(-hist // ps)                             # real pages per seq
    has_chunk = (np.zeros(b, np.int64) if q_lens is None else
                 (np.atleast_1d(np.asarray(q_lens)) > 0).astype(np.int64))
    seq_of_pg = np.repeat(np.arange(b), npg)
    pg_off = np.concatenate([[0], np.cumsum(npg)])
    pg_idx = np.arange(pg_off[-1]) - pg_off[seq_of_pg]
    pages_flat = tables[seq_of_pg, pg_idx]
    if (pages_flat < 0).any():
        bad_idx = np.unique(seq_of_pg[pages_flat < 0])
        bad = (np.atleast_1d(np.asarray(seq_ids))[bad_idx].tolist()
               if seq_ids is not None else bad_idx.tolist())
        what = "seq slot(s)" if seq_ids is not None else "batch row(s)"
        raise IndexError(f"work queue over unmapped page(s) for {what} "
                         f"{bad} — grow capacity first")
    counts_flat = np.minimum(ps, hist[seq_of_pg] - ps * pg_idx)
    # a page holding a chunk token: the chunk's queries see it causally
    causal = ver[seq_of_pg] & (ps * pg_idx + counts_flat > ctx[seq_of_pg])
    kinds_flat = np.where(causal, PA.KIND_CAUSAL + ctx[seq_of_pg]
                          - ps * pg_idx, PA.KIND_PAGE)
    n_per_seq = npg + has_chunk
    off = np.concatenate([[0], np.cumsum(n_per_seq)])
    tot = int(off[-1])
    pages_c = np.zeros(tot, np.int64)
    counts_c = np.zeros(tot, np.int64)
    kinds_c = np.zeros(tot, np.int64)
    pg_pos = off[seq_of_pg] + pg_idx
    pages_c[pg_pos] = pages_flat
    counts_c[pg_pos] = counts_flat
    kinds_c[pg_pos] = kinds_flat
    if q_lens is not None:
        ch = np.nonzero(has_chunk)[0]
        counts_c[off[ch] + npg[ch]] = np.atleast_1d(
            np.asarray(q_lens)).astype(np.int64)[ch]
        kinds_c[off[ch] + npg[ch]] = np.where(ver[ch], PA.KIND_SELF,
                                              PA.KIND_CHUNK)
    # tile each seq's item stream across its kv heads, row-major
    reps = np.repeat(n_per_seq, hkv)
    bs = np.cumsum(reps) - reps
    within = np.arange(int(reps.sum())) - np.repeat(bs, reps)
    src = np.repeat(off[np.repeat(np.arange(b), hkv)], reps) + within
    w = max(len(src), 1)
    wb = max(MIN_ITEMS, 1 << (w - 1).bit_length())
    desc = np.zeros((wb, 4), np.int32)
    desc[:, 0] = b * hkv if pad_row is None else pad_row
    desc[:len(src), 0] = np.repeat(np.arange(b * hkv), reps)
    desc[:len(src), 1] = pages_c[src]
    desc[:len(src), 2] = counts_c[src]
    desc[:len(src), 3] = kinds_c[src]
    return desc


def json_str(s: str) -> str:
    """``json.dumps(s)`` for text ``json.dumps`` wrote (printable ASCII):
    only its quotes and backslashes need escaping, which ``str.replace``
    does at memory speed where the encoder's scan of a snapshot with its
    pools takes seconds."""
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


class PagedKV4Cache:
    """Host-managed page allocator + device-resident int4 pools (on the
    card unless ``device="cpu"`` is asked for)."""

    # set by __init__ from the configs, or never part of a snapshot
    # (cometlint R1): the scales are static calibration, the page
    # storage is serialized through its k_pool/v_pool views (the scratch
    # page past the pool is not state)
    _SNAPSHOT_EXEMPT = frozenset({
        "cfg", "pcfg", "_k_pages", "_v_pages", "k_scale", "k_zero",
        "v_scale", "v_zero", "page_bytes", "faults", "heads", "mesh",
        "full_shape",
    })

    def __init__(self, cfg: ModelConfig, pcfg: PagedKV4Config,
                 num_layer_slots: int, kv_range: float = 16.0,
                 device="cuda", mesh=None):
        """``mesh``: a tensor-parallel rank's mesh; the pools then hold
        the rank's slice of the kv heads, and a snapshot gathers the
        others' over it."""
        device = resolve_device(device)
        self.cfg = cfg
        self.pcfg = pcfg
        d = cfg.head_dim
        self.mesh = mesh
        hkv = cfg.num_kv_heads // (mesh.size if mesh is not None else 1)
        # (first, count) of the kv heads the pools hold
        self.heads = (mesh.model_rank * hkv if mesh is not None else 0, hkv)
        # the whole cache's pool shape, the one a snapshot carries
        self.full_shape = (num_layer_slots, pcfg.num_pages, pcfg.page_size,
                           cfg.num_kv_heads, d // 2)
        # one page past the pool takes the writes of a bucketed step's
        # padding tokens (page == num_pages): the in-place counterpart of
        # the reference's dropped out-of-range scatter, with no mask (and
        # no host sync) on the write
        shape = (num_layer_slots, pcfg.num_pages + 1, pcfg.page_size, hkv,
                 d // 2)
        self._k_pages = torch.zeros(shape, dtype=torch.uint8, device=device)
        self._v_pages = torch.zeros(shape, dtype=torch.uint8, device=device)
        self.k_pool = self._k_pages[:, :pcfg.num_pages]
        self.v_pool = self._v_pages[:, :pcfg.num_pages]
        # symmetric range ±kv_range mapped onto [0, 15] (asym affine)
        self.k_scale = torch.full((hkv, 1, d), kv_range / 15.0,
                                  dtype=torch.float32, device=device)
        self.k_zero = torch.full((hkv, 1, d), 7.5, dtype=torch.float32,
                                 device=device)
        self.v_scale = self.k_scale.clone()
        self.v_zero = self.k_zero.clone()

        self.block_table = np.full(
            (pcfg.max_seqs, pcfg.max_pages_per_seq), -1, np.int32)
        self.seq_len = np.zeros((pcfg.max_seqs,), np.int32)
        self.page_count = np.zeros((pcfg.max_seqs,), np.int32)
        self.free_pages = list(range(pcfg.num_pages - 1, -1, -1))
        self.active = set()
        self.ref = np.zeros((pcfg.num_pages,), np.int32)
        self.prefix_index: dict = {}
        self.page_key: dict = {}
        self._reclaimable: OrderedDict = OrderedDict()
        # bytes one page pins in the pools (K + V across the layer stack,
        # every kv head: the byte cap means the same on every rank)
        self.page_bytes = (2 * num_layer_slots * pcfg.page_size
                           * cfg.num_kv_heads * (d // 2))
        self.prefix_evicted_pages = 0
        # the engine's fault injector (None: no fault points armed)
        self.faults = None

    # ------------------------------------------------------------ allocator

    @property
    def pages_free(self) -> int:
        return len(self.free_pages) + len(self._reclaimable)

    @property
    def prefix_reclaimable_bytes(self) -> int:
        """Pool bytes pinned by published ref==0 pages (the LRU)."""
        return len(self._reclaimable) * self.page_bytes

    def _evict_reclaimable(self) -> Optional[int]:
        if not self._reclaimable:
            return None
        p, key = self._reclaimable.popitem(last=False)
        del self.prefix_index[key]
        del self.page_key[p]
        self.prefix_evicted_pages += 1
        return p

    def _acquire_page(self) -> Optional[int]:
        """A free page, else the LRU reclaimable prefix page (evicted
        before any preemption can fire); None when both are dry, or when
        an injected ``alloc_page`` fault says so."""
        if self.faults is not None and self.faults.check("alloc_page"):
            return None         # injected exhaustion — same shape as dry
        if self.free_pages:
            p = self.free_pages.pop()
        else:
            p = self._evict_reclaimable()
            if p is None:
                return None
        self.ref[p] = 1
        return p

    def _adopt_page(self, p: int):
        if int(self.ref[p]) == 0:
            self._reclaimable.pop(p, None)
        self.ref[p] += 1

    def _release_page(self, p: int):
        self.ref[p] -= 1
        if self.ref[p] > 0:
            return
        key = self.page_key.get(p)
        if key is not None and self.prefix_index.get(key) == p:
            self._reclaimable[p] = key      # cached, evicted LRU-first
            cap = self.pcfg.reclaimable_max_bytes
            while cap is not None and self.prefix_reclaimable_bytes > cap:
                self.free_pages.append(self._evict_reclaimable())
        else:
            self.free_pages.append(p)

    def pages_needed(self, tokens: int) -> int:
        ps = self.pcfg.page_size
        return (tokens + ps - 1) // ps

    def pages_available_for(self, prefix_pages) -> int:
        reserved = sum(1 for p in prefix_pages if int(self.ref[int(p)]) == 0)
        return self.pages_free - reserved

    def allocate_seq(self, seq_id: int, reserve_tokens: int,
                     prefix_pages: tuple = (),
                     prefix_tokens: int = 0) -> bool:
        """Reserve pages for ``reserve_tokens``, adopting ``prefix_pages``
        (published, refcounted) first; False if it cannot fit."""
        need = max(self.pages_needed(reserve_tokens), len(prefix_pages))
        if (need - len(prefix_pages) > self.pages_available_for(prefix_pages)
                or seq_id in self.active
                or need > self.pcfg.max_pages_per_seq):
            return False
        for i, p in enumerate(prefix_pages):
            self._adopt_page(int(p))
            self.block_table[seq_id, i] = int(p)
        for i in range(len(prefix_pages), need):
            p = self._acquire_page()
            if p is None:
                # roll back every reference this call took
                for j in range(i):
                    self._release_page(int(self.block_table[seq_id, j]))
                self.block_table[seq_id, :i] = -1
                return False
            self.block_table[seq_id, i] = p
        self.seq_len[seq_id] = prefix_tokens
        self.page_count[seq_id] = need
        self.active.add(seq_id)
        return True

    def extend_seq(self, seq_id: int) -> bool:
        """Capacity for one more token; may grab a new page."""
        need = self.pages_needed(int(self.seq_len[seq_id]) + 1)
        have = int(self.page_count[seq_id])
        if need <= have:
            return True
        if need > self.pcfg.max_pages_per_seq:
            return False
        p = self._acquire_page()
        if p is None:
            return False
        self.block_table[seq_id, have] = p
        self.page_count[seq_id] = have + 1
        return True

    def at_capacity(self, seq_id: int) -> bool:
        """True when the sequence can never grow another token."""
        return (self.pages_needed(int(self.seq_len[seq_id]) + 1)
                > min(self.pcfg.max_pages_per_seq, self.pcfg.num_pages))

    def grow_to(self, seq_id: int, target_tokens: int) -> int:
        """Acquire pages toward ``target_tokens``; → token capacity."""
        cap = min(self.pages_needed(target_tokens),
                  self.pcfg.max_pages_per_seq)
        have = int(self.page_count[seq_id])
        while have < cap:
            p = self._acquire_page()
            if p is None:
                break
            self.block_table[seq_id, have] = p
            have += 1
        self.page_count[seq_id] = have
        return have * self.pcfg.page_size

    def truncate_seq(self, seq_id: int, new_len: int) -> int:
        """Set the sequence's resident length to ``new_len`` tokens,
        releasing every page past ``pages_needed(new_len)`` — the
        speculative-decode rollback: a verify chunk writes int4 KV for
        the whole k+1-token draft, and the unaccepted tail is retracted
        here, pages returning to their pre-draft baseline.

        Pages drop through :meth:`_release_page`, as in ``free_seq``, so
        a shared (adopted) page survives for its other owners and a
        published page reaching ref 0 goes to the reclaimable LRU, still
        matchable, instead of the free list. ``new_len`` may lie past
        ``seq_len``, up to the page-backed capacity: the verify chunk
        writes KV beyond ``seq_len`` and the accepted length lands here
        in one move. Stale int4 bytes past ``new_len`` stay in the kept
        pages; attention masks by length and the next write overwrites
        them. → the number of page references dropped."""
        if seq_id not in self.active:
            raise ValueError(f"truncate_seq: seq {seq_id} not active")
        have = int(self.page_count[seq_id])
        if not 0 <= new_len <= have * self.pcfg.page_size:
            raise ValueError(
                f"truncate_seq: new_len={new_len} outside the page-backed "
                f"range [0, {have * self.pcfg.page_size}] of seq {seq_id}")
        keep = self.pages_needed(new_len)
        for i in range(keep, have):
            self._release_page(int(self.block_table[seq_id, i]))
            self.block_table[seq_id, i] = -1
        self.page_count[seq_id] = min(have, keep)
        self.seq_len[seq_id] = new_len
        return max(0, have - keep)

    def free_seq(self, seq_id: int):
        pages = self.block_table[seq_id]
        for p in pages[pages >= 0]:
            self._release_page(int(p))
        self.block_table[seq_id, :] = -1
        self.seq_len[seq_id] = 0
        self.page_count[seq_id] = 0
        self.active.discard(seq_id)

    def quantize_kv(self, k, v):
        """k/v ``[B, T, Hkv, D]`` float → packed ``[B, Hkv, T, D/2]``."""
        return quantize_kv_with(k, v, self.k_scale, self.k_zero,
                                self.v_scale, self.v_zero)

    def write_prompt(self, layer: int, seq_id: int, k, v):
        """Write a whole prompt's packed KV (``[1, T, Hkv, D]`` float) into
        its pages, the last one padded with zero bytes; layer 0 sets the
        sequence's length to T."""
        kp, vp = self.quantize_kv(k, v)                  # [1, Hkv, T, D/2]
        t = kp.shape[2]
        ps = self.pcfg.page_size
        need = self.pages_needed(t)

        def paged(x):                                   # → [need, ps, Hkv, D/2]
            x = torch.nn.functional.pad(x[0], (0, 0, 0, need * ps - t))
            return x.reshape(x.shape[0], need, ps, -1).permute(1, 2, 0, 3)

        pages = torch.from_numpy(
            self.block_table[seq_id, :need].astype(np.int64)).to(kp.device)
        self._k_pages[layer][pages] = paged(kp)
        self._v_pages[layer][pages] = paged(vp)
        if layer == 0:
            self.seq_len[seq_id] = t

    def token_dests(self, seq_ids, positions):
        """:meth:`token_dests_np` on the device, resolved once per step and
        reused by every layer's :meth:`scatter_tokens`."""
        pages, offs = self.token_dests_np(seq_ids, positions)
        dev = self.k_pool.device
        return (torch.from_numpy(pages.astype(np.int64)).to(dev),
                torch.from_numpy(offs.astype(np.int64)).to(dev))

    def scatter_tokens(self, layer: int, pages, offs, k, v):
        """Quantize N tokens' KV (``[B, T, Hkv, D]`` float, B·T = N in
        the order of ``pages``/``offs``) and write it in place."""
        kq, vq = self.quantize_kv(k, v)                  # [B, Hkv, T, D/2]
        hkv, half = kq.shape[1], kq.shape[-1]
        self.write_kv(layer, pages, offs,
                      kq.transpose(1, 2).reshape(-1, hkv, half),
                      vq.transpose(1, 2).reshape(-1, hkv, half))

    def write_kv(self, layer: int, pages, offs, kq, vq):
        """Write packed KV ``[N, Hkv, D/2]`` of N tokens in place at
        (page, offset); page ``num_pages`` is the padding tokens' trash."""
        self._k_pages[layer][pages, offs] = kq
        self._v_pages[layer][pages, offs] = vq

    def advance(self, seq_ids):
        for s in np.atleast_1d(seq_ids):
            self.seq_len[s] += 1

    # ------------------------------------------------- full-state snapshot

    def snapshot_state(self) -> str:
        """The whole cache as the reference's JSON blob, for journaled
        crash recovery (``serving/recovery.py``): the int4 pool bytes
        (base64, ``pool_shape`` ``[L, P, ps, Hkv, D/2]``; the scratch page
        past the pool is not part of it) and every piece of host
        allocator state in iteration order (free-list and reclaimable-LRU
        order both steer later page choices). Each pool comes to the host
        in one copy. A blob from either package restores in the other.
        The pools' base64 needs no JSON escaping, so it is spliced into
        the JSON text rather than scanned by the encoder (seconds for the
        pools of a full-size model)."""
        def b64(pool):
            host = pool.contiguous().cpu()
            if self.mesh is not None:   # every rank's heads, in order
                host = torch.cat(host_all_gather(host, self.mesh), dim=3)
            return base64.b64encode(host.numpy()).decode()

        meta = json.dumps({
            "block_table": self.block_table.tolist(),
            "seq_len": self.seq_len.tolist(),
            "page_count": self.page_count.tolist(),
            "free_pages": [int(p) for p in self.free_pages],
            "ref": self.ref.tolist(),
            "active": sorted(int(s) for s in self.active),
            "prefix_index": {k.hex(): int(v)
                             for k, v in self.prefix_index.items()},
            "page_key": {int(p): k.hex() for p, k in self.page_key.items()},
            "reclaimable": [[int(p), k.hex()]
                            for p, k in self._reclaimable.items()],
            "prefix_evicted_pages": self.prefix_evicted_pages,
        })
        return (f'{{"pool_shape": {json.dumps(list(self.full_shape))}, '
                f'"pools": {{"k": "{b64(self.k_pool)}", '
                f'"v": "{b64(self.v_pool)}"}}, {meta[1:]}')

    def restore_state(self, blob: str):
        """Load a :meth:`snapshot_state` blob (this package's or the
        reference's) into this cache, built with the same configs: a
        blob of another pool shape raises. Each pool goes to the device
        in one copy; decode then resumes on the exact pool bytes and
        allocator order of the snapshotted cache."""
        state = json.loads(blob)
        shape = tuple(state["pool_shape"])
        if shape != self.full_shape:
            raise ValueError(
                f"snapshot pool shape {shape} != cache pool shape "
                f"{self.full_shape}: restore needs an "
                "identically configured cache")
        first, count = self.heads
        for pool, key in ((self.k_pool, "k"), (self.v_pool, "v")):
            host = np.frombuffer(base64.b64decode(state["pools"][key]),
                                 np.uint8).reshape(shape)
            pool.copy_(torch.from_numpy(
                host[:, :, :, first:first + count].copy()))
        self.block_table = np.asarray(state["block_table"], np.int32)
        self.seq_len = np.asarray(state["seq_len"], np.int32)
        self.page_count = np.asarray(state["page_count"], np.int32)
        self.free_pages = list(state["free_pages"])
        self.ref = np.asarray(state["ref"], np.int32)
        self.active = set(state["active"])
        self.prefix_index = {bytes.fromhex(k): int(v)
                             for k, v in state["prefix_index"].items()}
        self.page_key = {int(p): bytes.fromhex(k)
                         for p, k in state["page_key"].items()}
        self._reclaimable = OrderedDict(
            (int(p), bytes.fromhex(k)) for p, k in state["reclaimable"])
        self.prefix_evicted_pages = state.get("prefix_evicted_pages", 0)

    # ---------------------------------------------------------- prefix cache

    def _page_keys(self, tokens, nfull: int) -> list:
        """Chained SHA-256 page digests: key i commits to every token
        through page i (collision-resistant, unlike builtin hashing)."""
        ps = self.pcfg.page_size
        keys, key = [], b""
        for i in range(nfull):
            chunk = np.asarray(tokens[i * ps:(i + 1) * ps], np.int64)
            key = hashlib.sha256(key + chunk.tobytes()).digest()
            keys.append(key)
        return keys

    def match_prefix(self, tokens) -> tuple[list, int]:
        """Longest published prefix → (pages, matched tokens); capped one
        token short of the prompt so prefill always yields logits."""
        nfull = max(0, (len(tokens) - 1)) // self.pcfg.page_size
        pages = []
        for key in self._page_keys(tokens, nfull):
            p = self.prefix_index.get(key)
            if p is None:
                break
            pages.append(p)
        return pages, len(pages) * self.pcfg.page_size

    def publish_prefix(self, seq_id: int, tokens):
        """Publish the sequence's full prompt pages (first publisher wins)."""
        nfull = len(tokens) // self.pcfg.page_size
        for i, key in enumerate(self._page_keys(tokens, nfull)):
            if key in self.prefix_index:
                continue
            page = int(self.block_table[seq_id, i])
            if self.page_key.get(page) is not None:
                continue
            self.prefix_index[key] = page
            self.page_key[page] = key

    # ------------------------------------------------------- step views

    def token_dests_np(self, seq_ids, positions):
        """Validated (physical page, in-page offset) per token; an injected
        ``append_kv`` fault raises before any pool write."""
        if self.faults is not None and self.faults.check("append_kv"):
            raise InjectedFault("append_kv: injected destination failure")
        seq_ids = np.atleast_1d(np.asarray(seq_ids))
        pos = np.atleast_1d(np.asarray(positions))
        ps = self.pcfg.page_size
        pages_np = self.block_table[seq_ids, pos // ps]
        if (pages_np < 0).any():
            raise IndexError(
                f"write into unmapped page(s) for seqs "
                f"{seq_ids[pages_np < 0].tolist()} — grow capacity first")
        return pages_np.astype(np.int32), (pos % ps).astype(np.int32)

    def work_queue_np(self, seq_ids, ctx_lens, q_lens=None,
                      pad_row: Optional[int] = None,
                      verify=None,
                      num_kv_heads: Optional[int] = None) -> np.ndarray:
        """Stream-K descriptors for these sequences' real pages
        (``verify``: :func:`build_work_queue`'s speculating rows),
        tiled over ``num_kv_heads`` heads (default the config's; a
        tensor-parallel rank builds one set at its local head count,
        valid on every rank, since every head walks the same pages)."""
        return build_work_queue(
            self.block_table[np.asarray(seq_ids)], ctx_lens,
            self.pcfg.page_size, num_kv_heads or self.cfg.num_kv_heads,
            q_lens, pad_row, seq_ids=seq_ids, verify=verify)

    def block_tables_np(self, seq_ids, npages: int) -> np.ndarray:
        """``[B, npages]`` int32 table with unmapped slots (-1) clamped to
        page 0 (masked by length in the kernels, never read for values)."""
        tables = self.block_table[np.asarray(seq_ids), :npages]
        return np.maximum(tables, 0).astype(np.int32)

    def block_tables_device(self, seq_ids, max_len: int) -> torch.Tensor:
        """The dense schedule's ``[B, NP]`` table, sliced to the pages
        covering ``max_len`` tokens."""
        return torch.from_numpy(self.block_tables_np(
            seq_ids, self.pages_needed(max_len))).to(self.k_pool.device)

    def lengths_device(self, seq_ids) -> torch.Tensor:
        return torch.from_numpy(
            self.seq_len[np.asarray(seq_ids)].astype(np.int32)).to(
                self.k_pool.device)

    def gather_kv(self, layer: int, seq_ids, max_len: int):
        """[Baseline] a decode batch's packed KV made contiguous →
        (k, v ``[B, Hkv, max_len, D/2]`` uint8, lengths ``[B]``); unmapped
        pages read page 0 and lie past each row's length."""
        ps = self.pcfg.page_size
        npages = (max_len + ps - 1) // ps
        seq_ids = np.asarray(seq_ids)
        tables = torch.from_numpy(
            self.block_tables_np(seq_ids, npages).astype(np.int64)).to(
                self.k_pool.device)
        b = len(seq_ids)

        def gather(pool):
            pg = pool[layer][tables]                  # [B, NP, ps, Hkv, D/2]
            pg = pg.reshape(b, npages * ps, *pg.shape[3:]).transpose(1, 2)
            return pg[:, :, :max_len]

        return (gather(self.k_pool), gather(self.v_pool),
                self.lengths_device(seq_ids))
