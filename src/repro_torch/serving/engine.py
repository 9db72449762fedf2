"""Serving engine over the paged KV4 cache (``repro/serving/engine.py``).

The default step (``unified_step=True``, chunked prefill, paged decode)
issues ONE forward for the union of decode rows (a chunk of 1 with int4
paged history) and prompt chunks of partially prefilled requests, packed
into a ragged token stream. Per layer: the config's norm (RMSNorm or
LayerNorm) → q/k/v through W4Ax (act-quant int4 + int8 → W4A4 + W4A8,
plus the q/k/v bias where the config has one) → RoPE → quantize the
step's KV and write it into the int4 pools (in place) → paged attention
(fp chunk queries over int4 history pages plus each row's causal fp
chunk) → wo → the MLP (SwiGLU, or StarCoder2's tanh-GELU), both W4Ax,
or for the ``moe`` family the routed experts (``layers/mlp.py``
``moe_apply``: capacity-dropped top-k over every row of the forward's
token tensor, padding rows included, as the reference routes them; the
expert projections one expert-batched W4Ax launch each) and the shared
experts. Under ``QuantConfig(weight_only=True)`` every projection is
W4A16 instead (dequantized bf16 weights, ``core/qlinear.py``).
Attention follows ``attention_schedule``: the
work-queue kernel with its split-KV combine, or the dense block-table
kernel. A step in which no row has history yet uses plain fp causal
attention instead. The head runs on the last token of each row (every
chunk position of a speculating row) and the sampler runs on the host:
an argmax for greedy rows, JAX's threefry draw keyed by (request id,
position) for stochastic ones (``serving/sampling.py``).

Speculative decode (``SamplingParams.speculation=k``, unified step): a
host draft source (``serving/speculation.py``, n-gram prompt lookup by
default) proposes up to k tokens per decode row, and the row rides the
same forward as a qlen-(1+k) chunk (its last sampled token and the
drafts, in-flight KV fake-quantized like every decode token). Greedy
rows accept drafts while they match the argmax, stochastic rows by
rejection sampling against the point-mass draft; the first rejection
commits the corrected token, full acceptance a bonus token. The cache
lands the row at its committed length with ``truncate_seq`` (rejected
drafts' pages released refcount- and prefix-safely). Drafts debit the
step's token budget; ``spec_draft_tokens`` = ``spec_accepted_tokens`` +
``spec_rollback_tokens``.

The measured baselines of the reference run too: ``unified_step=False``
(a prefill forward, then a separate decode forward), ``prefill_mode=
"whole"`` (one fp forward per prompt) and ``decode_attention="gather"``
(a decode batch's pages gathered contiguously for the KV4 decode kernel).
These split forwards are eager and unbucketed, as in the reference.

Shapes of the unified step are bucketed to powers of two like the
reference's jit cache keys (tokens ≥ 8, rows, chunk length, work items or
table pages), so the same padded layout reaches the kernels. Padding
tokens carry page ``num_pages`` and row ``nb``; where JAX drops such
out-of-range scatters and clamps gathers, the port writes them to a
scratch page (the pools hold one page more) and a scratch row, and clamps
the gather (an out-of-range index on the card is a device-side assert).

``step()`` never raises: a failure in the unified forward quarantines
that step's batch to FAILED (``failed_count``), anything else is
swallowed into ``internal_errors``/``last_error``. Per-request deadlines
(``SamplingParams.deadline_ms``/``ttft_ms``) expire at each step boundary
before admission (``TIMED_OUT``, ``timeout_count``); with
``max_waiting`` a submit against a full waiting queue is rejected
(``FAILED("queue_full")``, ``rejected_count``) and a preemption victim
that cannot re-queue is shed (``FAILED("shed")``, ``shed_count``). Every
lifecycle stamp (arrival, first token, terminal event) comes from the
injectable ``clock``.

Fault injection (``serving/faults.py``; ``EngineConfig.inject_faults`` or
``Engine(faults=...)``) arms the reference's points: ``alloc_page`` and
``append_kv`` in the cache, ``forward`` (raise, or NaN one consumed
logits row), ``sample``, ``emit_event``, ``draft`` and ``verify`` here.
With ``sanitize=True`` the step-boundary sanitizers
(``serving/sanitize.py``) run after every step, outside the backstop,
and raise ``SanitizerError`` on the first broken invariant.

``snapshot(full=True)`` serializes the engine in the reference's JSON
blob (the scheduler's exact split and cursors, the cache with its int4
pool bytes, the step and uid counters) and ``Engine.restore`` resumes
from it the very next step bit for bit, on the device it is given; the
legacy ``snapshot()`` demotes running work to waiting. Recovery logs and
replica groups are built on them (``serving/recovery.py``,
``serving/replication.py``).

Tensor parallelism (``Engine(..., mesh=, param_axes=)``, a ``(1, M)``
mesh from ``launch/mesh.py``): one process per rank, every rank running
this same host program (scheduler, prefix index, page allocator, sampler,
drafts, fault schedule) on its shard of the weights and of the pools. The
projections shard by ``SERVE_RULES``: wq/wk/wv/w_up/w_gate by columns
(each rank computes its heads and its FFN channels whole), wo/w_down by
rows, whose f32 partial sums are the two seams of a layer: every rank
all-gathers them and adds them in rank order, then adds the bias once
and rounds to bf16 once (:func:`_row_linear`), so every rank holds the
same bits, run after run. The pools shard over kv heads; page ids stay a
host-global namespace, so one set of work-queue descriptors at the local
head count drives every rank (``attn_work_items_per_shard``). The
embedding and the head are replicated. The clock is rank 0's reading,
broadcast once a step (and at each submit); ``sanitize=True`` also
checks that every rank holds the same tokens and scheduler state. The
seams add one device's 128-channel blocks in another grouping (each
shard's blocks in order, then the shards in rank order): one device
computing wo and w_down as those K-slices, summed in rank order, gives
the mesh's bits (the TP tests' ``serial_seams``), and where a shard holds
one block that is one device's own sum. Below ``int4_fraction=1.0`` a
shard also rounds its own INT4/INT8 split, as the reference's
``shard_map`` does. An exception other than an injected fault is fatal
to a rank under a mesh (:meth:`Engine._rank_local`). A ``RecoveryLog``
rides along on every rank (``serving/recovery.py``), and replica groups
take one mesh per replica (``serving/replication.py``). Not ported yet:
MoE under a mesh (expert parallelism) and a data axis above 1 (ROADMAP
Queue 1).

FMPQ-planned params (``"perm"`` on a projection, ``LM.quantize(...,
plans=)`` or ``convert.params_from_jax``) serve on one device through
the dispatcher's gather before the fused act-quant (``core/qlinear.py``);
under a mesh, and on an expert stack, they are refused (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import qlinear as QL
from repro_torch.core import quantizer as Q
from repro_torch.kernels import ops
from repro_torch.layers import attention as ATT
from repro_torch.layers import common as C
from repro_torch.layers import mlp as MLP
from repro_torch.models.lm import ENGINE_FAMILIES, LM, QuantConfig
from repro_torch.parallel import mesh as PM
from repro_torch.parallel import sharding as SH
from repro_torch.serving import kv_cache as KVC
from repro_torch.serving import sampling as SMP
from repro_torch.serving.api import (RequestHandle, RequestOutput,
                                     RequestState, SamplingParams)
from repro_torch.serving.faults import FaultInjector, InjectedFault
from repro_torch.serving.sanitize import check_engine
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.speculation import DraftSource, PromptLookupDraft

__all__ = ["Engine", "EngineConfig", "SamplingParams", "RequestState",
           "RequestOutput", "RequestHandle"]


def _bucket(n: int, lo: int = 1) -> int:
    """Round ``n`` up to a power of two (≥ lo) — the reference's shape key."""
    return max(lo, 1 << max(int(n) - 1, 0).bit_length())


def _pad_to(a, n: int, fill=0) -> np.ndarray:
    out = np.full((n,), fill, np.int64)
    out[: len(a)] = a
    return out


def _planned(params) -> list:
    """The paths of the block projections that carry an FMPQ ``perm``."""
    def walk(tree, path):
        if "perm" in tree:
            yield path
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
    return [p for i, b in enumerate(params["blocks"])
            for p in walk(b, (i,))]


def _row_linear(p, x: torch.Tensor, quant, mesh) -> torch.Tensor:
    """A row-parallel (K-sharded) projection, the tensor-parallel seam:
    each rank's K-slice gives f32 partial sums, which every rank
    all-gathers and adds in rank order; the bias is added once, after the
    sum, and the result rounded to bf16 once. The act-quant sees the bf16
    input, as on one device. ``mesh=None``: ``C.linear``."""
    if mesh is None:
        return C.linear(p, x, quant)
    y = QL.dispatch_qlinear({k: v for k, v in p.items() if k != "b"},
                            x.to(torch.bfloat16), quant,
                            out_dtype=torch.float32)
    y = PM.reduce_partials(y, mesh)
    if "b" in p:
        y = y + p["b"].float()
    return y.to(torch.bfloat16)


def _mlp_row(p, x: torch.Tensor, quant, act: str, mesh) -> torch.Tensor:
    """The MLP with its down projection as the second seam: up/gate are
    column-sharded (each rank's channels whole), the activation stays
    local. ``mesh=None``: ``MLP.mlp_apply``'s arithmetic."""
    if act == "swiglu":
        up, gate = C.linears([p["w_up"], p["w_gate"]], x, quant)
        h = MLP.silu_bf16(gate) * up
    elif act == "gelu":
        h = MLP.gelu_bf16(C.linear(p["w_up"], x, quant))
    else:
        raise ValueError(act)
    return _row_linear(p["w_down"], h, quant, mesh)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 32
    num_pages: int = 512
    page_size: int = 64
    max_pages_per_seq: int = 64
    temperature: float = 0.0        # 0 → greedy
    top_k: int = 40
    decode_attention: str = "paged"  # "paged" (block tables) | "gather"
    prefill_mode: str = "chunked"    # "chunked" (ragged) | "whole"
    prefill_chunk_tokens: int = 64  # per-step token budget (chunks + decode)
    kv_range: float = 16.0          # calibrated |k|,|v| range → int4 scales
    unified_step: bool = True       # ONE forward per step; False → split
    prefix_cache: bool = True       # publish/reuse shared prompt pages
    attention_schedule: str = "work_queue"  # "work_queue" | "dense"
    prefix_cache_max_bytes: Optional[int] = None  # byte cap on the
    #                                reclaimable prefix-page LRU
    max_waiting: Optional[int] = None  # bound on the waiting queue: submits
    #                                past it are rejected ("queue_full")
    #                                and preemption victims shed
    inject_faults: Optional[str] = None  # fault schedule spec
    #                                (serving/faults.py grammar), e.g.
    #                                "forward:step=3,action=nan"
    sanitize: bool = False          # run the step-boundary sanitizers
    #                                (serving/sanitize.py) after every
    #                                step; SanitizerError on a violation

    def __post_init__(self):
        if self.max_waiting is not None and self.max_waiting < 1:
            raise ValueError("max_waiting must be >= 1 (None = unbounded)")
        if self.decode_attention not in ("paged", "gather"):
            raise ValueError(
                f"decode_attention must be 'paged' or 'gather', got "
                f"{self.decode_attention!r}")
        if self.prefill_mode not in ("chunked", "whole"):
            raise ValueError(
                f"prefill_mode must be 'chunked' or 'whole', got "
                f"{self.prefill_mode!r}")
        if self.prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1")
        if self.attention_schedule not in ("work_queue", "dense"):
            raise ValueError(
                f"attention_schedule must be 'work_queue' or 'dense', "
                f"got {self.attention_schedule!r}")

    @property
    def unified(self) -> bool:
        """The unified step needs chunked prefill and paged decode; the
        whole-prompt and gather baselines imply the split step."""
        return (self.unified_step and self.prefill_mode == "chunked"
                and self.decode_attention == "paged")

    @property
    def prefix_caching(self) -> bool:
        """Prefix reuse rides on chunked prefill: the whole-prompt
        baseline always forwards the full prompt."""
        return self.prefix_cache and self.prefill_mode == "chunked"


class Engine:
    # state a full snapshot leaves out (cometlint R1), as the reference's
    _SNAPSHOT_EXEMPT = frozenset({
        # rebuilt by __init__ / only meaningful in-process
        "lm", "params", "_events", "draft_source",
        # per-process observability counters
        "peak_prefill_fp_tokens", "interleaved_steps", "forward_calls",
        "prefix_hit_tokens", "prefill_tokens", "aborted_count",
        "failed_count", "timeout_count", "shed_count", "rejected_count",
        "callback_errors", "internal_errors", "last_error",
        "sanitize_checks", "attn_work_items", "attn_grid_items",
        "attn_dense_grid_items", "attn_forwards", "spec_draft_tokens",
        "spec_accepted_tokens", "spec_rollback_tokens", "spec_noop_count",
        "draft_errors", "attn_work_items_per_shard", "_step_now",
        "moe_dropped",
        # the mesh's size: rebuilt from the mesh a restore is given
        "tp_size",
    })

    def __init__(self, cfg: ModelConfig, params, quant: QuantConfig =
                 QuantConfig(), ecfg: EngineConfig = EngineConfig(), *,
                 device="cuda", clock=time.time, faults=None,
                 draft_source: Optional[DraftSource] = None, mesh=None,
                 param_axes=None):
        """``params``: the model's quantized parameters on ``device``
        (``LM.init`` or ``convert.params_from_jax``). ``clock``: the
        wall-clock source of arrival, first-token and terminal stamps and
        of deadline expiry (injectable, so deadline tests are exact).
        ``faults``: a :class:`FaultInjector` to ride along (else one built
        from ``ecfg.inject_faults``). ``draft_source``: the speculative
        draft proposer (default :class:`PromptLookupDraft`), consulted
        only for requests with ``SamplingParams.speculation > 0``.
        ``mesh``: a tensor-parallel rank's mesh (``launch/mesh.py``), the
        engine then on the mesh's device; ``param_axes``: the params'
        logical axes (``LM.axes``), needed when the model axis is above 1.
        ``params`` are then the whole model's, or this rank's shard of
        them (``LM.init(mesh=)``). The dense and moe families only, as
        the reference's engine: the others serve through ``LM.decode``."""
        if cfg.family not in ENGINE_FAMILIES:
            raise ValueError(
                f"paged engine supports dense/moe; {cfg.family} serves via "
                "LM.decode")
        self.device = C.resolve_device(device)
        self.mesh = mesh
        self.tp_size = mesh.size if mesh is not None else 1
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh lies on {mesh.device}, the "
                                 f"engine was asked for {self.device}")
            self.device = mesh.device
        if self.device.type == "cuda":
            C.no_tf32()
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params lie on {table.device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.quant = quant
        self.params = params
        self.ecfg = ecfg
        if any("moe" in path for path in _planned(params)):
            raise ValueError(
                "an expert stack with an FMPQ 'perm' is not ported (the "
                "reference builds none; ROADMAP Queue 1 item 15)")
        if mesh is not None:
            self._init_sharding(param_axes)
        self.lm = LM(cfg)
        self.cache = KVC.PagedKV4Cache(
            cfg,
            KVC.PagedKV4Config(
                num_pages=ecfg.num_pages, page_size=ecfg.page_size,
                max_seqs=ecfg.max_batch * 2,
                max_pages_per_seq=ecfg.max_pages_per_seq,
                reclaimable_max_bytes=ecfg.prefix_cache_max_bytes),
            num_layer_slots=cfg.num_layers, kv_range=ecfg.kv_range,
            device=self.device, mesh=mesh)
        self.sched = Scheduler(ecfg.max_batch, ecfg.max_batch * 2,
                               max_waiting=ecfg.max_waiting)
        self.clock = clock
        # shared with the cache, so alloc_page/append_kv fire at their
        # real call sites
        if faults is None:
            faults = (FaultInjector.from_spec(ecfg.inject_faults)
                      if ecfg.inject_faults else FaultInjector())
        self.faults = faults
        self.cache.faults = faults
        self.steps = 0
        self.tokens_generated = 0
        # forwards issued (exactly one per step with work), largest fp
        # prefill chunk, steps mixing prefill and decode rows
        self.forward_calls = 0
        self.peak_prefill_fp_tokens = 0
        self.interleaved_steps = 0
        self.prefix_hit_tokens = 0
        self.prefill_tokens = 0
        self.aborted_count = 0
        self.failed_count = 0
        self.timeout_count = 0
        self.shed_count = 0
        self.rejected_count = 0
        self.callback_errors = 0
        self.internal_errors = 0
        self.last_error: Optional[str] = None
        # step boundaries that passed the sanitizer (ecfg.sanitize)
        self.sanitize_checks = 0
        # speculative decode: drafted = accepted + rolled back; noops are
        # drafts suppressed with at most one token left, draft_errors the
        # raising or out-of-vocab draft calls degraded to plain decode
        self.draft_source = (draft_source if draft_source is not None
                             else PromptLookupDraft())
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_rollback_tokens = 0
        self.spec_noop_count = 0
        self.draft_errors = 0
        # attention-schedule counters (fig. 10): real work items (Σ real
        # pages + chunk items, per kv head; the same under both
        # schedules), grid items launched (work queue: the pow-2 padded
        # descriptor count; dense: the padded rectangle), the dense
        # rectangle the same forwards would launch, and the forwards that
        # attended over paged history
        self.attn_work_items = 0
        self.attn_grid_items = 0
        self.attn_dense_grid_items = 0
        self.attn_forwards = 0
        # per-rank real work: every rank attends its kv heads over the
        # same pages, so each gets attn_work_items / tp exactly
        self.attn_work_items_per_shard = [0] * self.tp_size
        # set to a list to collect, per MoE layer call, its count of
        # (token, expert) pairs dropped by capacity (0-d tensors: no host
        # sync on the forward path)
        self.moe_dropped: Optional[list] = None
        # the step's clock reading under a mesh (rank 0's, broadcast)
        self._step_now: Optional[float] = None
        self._by_id: dict[int, Request] = {}
        self._next_id = 0
        self._submit_seq = 0        # uid source: request ids are reusable
        self._events: list[RequestOutput] = []

    def counters(self) -> dict:
        """Every counter the engine keeps, plus the scheduler's."""
        return {
            "steps": self.steps, "tokens_generated": self.tokens_generated,
            "forward_calls": self.forward_calls,
            "peak_prefill_fp_tokens": self.peak_prefill_fp_tokens,
            "interleaved_steps": self.interleaved_steps,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefill_tokens": self.prefill_tokens,
            "aborted_count": self.aborted_count,
            "failed_count": self.failed_count,
            "timeout_count": self.timeout_count,
            "shed_count": self.shed_count,
            "rejected_count": self.rejected_count,
            "callback_errors": self.callback_errors,
            "internal_errors": self.internal_errors,
            "last_error": self.last_error,
            "attn_work_items": self.attn_work_items,
            "attn_grid_items": self.attn_grid_items,
            "attn_dense_grid_items": self.attn_dense_grid_items,
            "attn_forwards": self.attn_forwards,
            "attn_work_items_per_shard": list(self.attn_work_items_per_shard),
            "sanitize_checks": self.sanitize_checks,
            "spec_draft_tokens": self.spec_draft_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_rollback_tokens": self.spec_rollback_tokens,
            "spec_noop_count": self.spec_noop_count,
            "draft_errors": self.draft_errors,
            **self.sched.counters(),
        }

    # --------------------------------------------------- tensor parallelism

    def _init_sharding(self, param_axes):
        """Refuse what the reference's sharded engine refuses, then keep
        this rank's shard of the params: projections by ``SERVE_RULES``,
        the embedding and the head replicated (they gather and project
        with global ids). Divisibility is checked up front, because a
        partly sharded projection (w_packed split, w_scale whole) has no
        consistent shape. Params already shard-sized (``LM.init(mesh=)``)
        are kept as they are."""
        cfg, m, mesh, ecfg = self.cfg, self.tp_size, self.mesh, self.ecfg
        if _planned(self.params):
            raise ValueError(
                "FMPQ-planned params ('perm' on a projection) do not serve "
                "under a mesh: a row-parallel shard of wo/w_down holds a "
                "K-slice, which a full-K permutation crosses (ROADMAP "
                "Queue 1 item 14)")
        if mesh.shape.get("data", 1) != 1:
            raise NotImplementedError(
                "a data axis above 1 is not ported (ROADMAP Queue 1)")
        if param_axes is None and m > 1:
            raise ValueError(
                "TP-sharded serving needs param_axes — the axes tree "
                "LM.axes (or convert.axes_from_jax) gives beside the "
                "params")
        if not ecfg.unified:
            raise ValueError(
                "TP-sharded serving runs through the unified one-forward "
                "step; the split/whole/gather baselines are single-device")
        if cfg.family != "dense":
            raise NotImplementedError(
                "TP-sharded serving covers dense models; MoE needs expert-"
                "parallel dispatch at this seam (not ported yet, ROADMAP "
                "Queue 1)")
        if cfg.num_heads % m or cfg.num_kv_heads % m:
            raise ValueError(
                f"num_heads={cfg.num_heads}, num_kv_heads="
                f"{cfg.num_kv_heads} must both divide by the model axis "
                f"size {m}")
        if cfg.q_dim % (QL.BLOCK_K * m) or cfg.d_ff % (QL.BLOCK_K * m):
            raise ValueError(
                f"row-parallel W4Ax shards must hold whole {QL.BLOCK_K}-"
                f"channel quant blocks: q_dim={cfg.q_dim} and d_ff="
                f"{cfg.d_ff} must divide by {QL.BLOCK_K}*model="
                f"{QL.BLOCK_K * m}")
        n = self.params["blocks"][0]["attn"]["wq"]["w_packed"].shape[-1]
        if m == 1 or n == cfg.q_dim // m:
            return                      # whole (M = 1) or already a shard
        if n != cfg.q_dim:
            raise ValueError(f"wq has {n} columns: neither the model's "
                             f"{cfg.q_dim} nor a 1/{m} shard of them")
        specs = SH.tree_pspecs(param_axes, self.params, mesh, SH.SERVE_RULES)
        for name in ("embed", "lm_head"):
            specs[name] = {k: (None,) * self.params[name][k].dim()
                           for k in self.params[name]}
        self.params = SH.shard_tree(self.params, specs, mesh)

    def _now(self) -> float:
        """The clock. Under a mesh, rank 0's reading: the step's (read
        once and broadcast when the step starts), or outside a step one
        broadcast per call."""
        if self.mesh is None:
            return self.clock()
        if self._step_now is not None:
            return self._step_now
        return PM.broadcast_float(self.clock(), self.mesh)

    # ----------------------------------------------------- lifecycle API

    def submit(self, prompt: list[int],
               params: Optional[SamplingParams] = None,
               request_id: Optional[int] = None,
               on_event=None) -> RequestHandle:
        """Enqueue a request (QUEUED) and return its handle; ``params``
        defaults to the engine-wide temperature and top_k. Against a full
        bounded waiting queue the request is rejected instead: the handle
        resolves to a request already terminal in ``FAILED("queue_full")``,
        its terminal event emitted. A speculation k whose k + 1-token
        verify chunk cannot fit ``prefill_chunk_tokens`` raises."""
        if params is None:
            params = SamplingParams(temperature=self.ecfg.temperature,
                                    top_k=self.ecfg.top_k)
        if params.speculation + 1 > self.ecfg.prefill_chunk_tokens:
            raise ValueError(
                f"speculation={params.speculation} exceeds the per-step "
                f"token budget: the k+1-token verify chunk must fit "
                f"prefill_chunk_tokens={self.ecfg.prefill_chunk_tokens}")
        if params.speculation > 0 and params.max_new_tokens == 1:
            # its one token comes off the prefill's logits: speculation
            # can never engage
            self.spec_noop_count += 1
        if request_id is None:
            while self._next_id in self._by_id:
                self._next_id += 1
            request_id = self._next_id
        old = self._by_id.get(request_id)
        if old is not None and not old.state.terminal:
            raise ValueError(f"request_id {request_id} already in flight")
        req = Request(request_id=request_id, prompt=list(prompt),
                      max_new_tokens=params.max_new_tokens,
                      arrived_at=self._now(), params=params,
                      on_event=on_event, uid=self._submit_seq)
        self._submit_seq += 1
        self._by_id[request_id] = req
        if self.sched.waiting_full:
            self.sched.reject(req)
            self.rejected_count += 1
            self._emit(req)
        else:
            self.sched.submit(req)
        return RequestHandle(request_id=request_id, prompt_len=len(prompt))

    def _resolve(self, handle) -> Optional[Request]:
        rid = handle.request_id if isinstance(handle, RequestHandle) \
            else int(handle)
        return self._by_id.get(rid)

    def abort(self, handle) -> bool:
        """Cancel a request at any state; pages released refcount-exactly."""
        req = self._resolve(handle)
        if req is None or not self.sched.abort(req, self.cache):
            return False
        self.aborted_count += 1
        self._emit(req)
        return True

    def events(self) -> list[RequestOutput]:
        """Drain the engine-wide event queue."""
        evs, self._events = self._events, []
        return evs

    def stream(self, handle):
        """Yield one request's events as they happen, driving ``step()``."""
        req = self._resolve(handle)
        if req is None:
            return
        cursor = 0
        while True:
            while cursor < len(req.events):
                yield req.events[cursor]
                cursor += 1
            if req.state.terminal or not self.sched.has_work:
                return
            self.step()

    def result(self, handle) -> Optional[Request]:
        return self._resolve(handle)

    def release(self, handle) -> bool:
        """Drop a terminal request's retained state."""
        req = self._resolve(handle)
        if req is None or not req.state.terminal:
            return False
        self.sched.release(req)
        self._by_id.pop(req.request_id, None)
        req.events.clear()
        req.on_event = None
        return True

    def add_request(self, request_id: int, prompt: list[int],
                    max_new_tokens: int):
        """Batch API: submit with the engine-wide sampling defaults."""
        self.submit(prompt,
                    SamplingParams(max_new_tokens=max_new_tokens,
                                   temperature=self.ecfg.temperature,
                                   top_k=self.ecfg.top_k),
                    request_id=request_id)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Batch API: step until all work drains."""
        while self.sched.has_work and self.steps < max_steps:
            self.step()
        return self.sched.finished

    # ------------------------------------------------------ snapshots

    def snapshot(self, full: bool = False) -> str:
        """Serialize engine state for crash recovery. Legacy (default):
        the scheduler alone, running work demoted to waiting to
        re-prefill on restore (plausible, not bit for bit). ``full=True``:
        the scheduler's exact split and cursors and the whole cache (int4
        pool bytes, block tables, free-list and prefix-LRU order), so a
        restore resumes the very next step bit for bit."""
        if full:
            rest = json.dumps({
                "format": "engine_full",
                "sched": self.sched.snapshot(full=True),
                "steps": self.steps,
                "tokens_generated": self.tokens_generated,
                "next_id": self._next_id,
                "submit_seq": self._submit_seq,
            })
            # the cache's blob (its pools) goes in escaped by KVC.json_str
            return (rest[:-1] + ', "cache": '
                    + KVC.json_str(self.cache.snapshot_state()) + "}")
        return self.sched.snapshot()

    @classmethod
    def restore(cls, blob: str, cfg: ModelConfig, params,
                quant: QuantConfig = QuantConfig(),
                ecfg: EngineConfig = EngineConfig(), *, device="cuda",
                clock=time.time, faults=None,
                draft_source: Optional[DraftSource] = None, mesh=None,
                param_axes=None) -> "Engine":
        """A new engine on ``device`` (the constructor's arguments) with
        the state of a :meth:`snapshot` blob, this package's or the
        reference's. A full blob of another pool shape raises. With a
        ``mesh`` every rank restores the same blob, each keeping its kv
        heads of the pools (a tensor-parallel blob holds them all, so it
        restores into one device too, and one device's into a mesh)."""
        eng = cls(cfg, params, quant, ecfg, device=device, clock=clock,
                  faults=faults, draft_source=draft_source, mesh=mesh,
                  param_axes=param_axes)
        state = json.loads(blob)
        if isinstance(state, dict) and state.get("format") == "engine_full":
            eng.sched = Scheduler.restore(
                state["sched"], ecfg.max_batch, ecfg.max_batch * 2,
                max_waiting=ecfg.max_waiting)
            eng.cache.restore_state(state["cache"])
            eng.steps = state["steps"]
            eng.tokens_generated = state["tokens_generated"]
            eng._next_id = state["next_id"]
            eng._by_id = {r.request_id: r for r in
                          list(eng.sched.waiting) + eng.sched.running
                          + eng.sched.finished}
            eng._restore_uids(state.get("submit_seq"))
            return eng
        eng.sched = Scheduler.restore(blob, ecfg.max_batch,
                                      ecfg.max_batch * 2,
                                      max_waiting=ecfg.max_waiting)
        eng._by_id = {r.request_id: r for r in
                      list(eng.sched.waiting) + eng.sched.finished}
        eng._restore_uids(None)
        return eng

    def _restore_uids(self, submit_seq):
        """Re-establish the incarnation counter after a restore: requests
        of a blob without uids (the legacy snapshot) get fresh ones, so
        the recovery journal's ``(uid, ord)`` keys stay unique."""
        reqs = (list(self.sched.waiting) + self.sched.running
                + self.sched.finished)
        top = max((r.uid for r in reqs), default=-1) + 1
        self._submit_seq = max(top, submit_seq or 0)
        for r in reqs:
            if r.uid < 0:
                r.uid = self._submit_seq
                self._submit_seq += 1

    # ----------------------------------------------------------- events

    def _emit(self, req: Request, token: Optional[int] = None):
        """Single event choke point; at most one terminal event. A
        throwing ``on_event`` (or an injected ``emit_event`` fault) is
        detached and counted; the event log keeps the event."""
        if token is None:
            if req.terminal_emitted:
                return
            req.terminal_emitted = True
            if not req.finished_at:     # the TPOT window's end
                req.finished_at = self._now()
        out = RequestOutput(
            request_id=req.request_id, state=req.state, token=token,
            num_generated=len(req.generated), stop_reason=req.stop_reason,
            finished=req.state.terminal)
        self._events.append(out)
        req.events.append(out)
        if req.on_event is not None:
            try:
                if self.faults.check("emit_event"):
                    raise InjectedFault(
                        "emit_event: injected callback failure")
                req.on_event(out)
            except Exception:  # noqa: BLE001 — user-callback boundary:
                # client code may raise anything; detach + count it so
                # one bad callback can't poison the serving loop
                self.callback_errors += 1
                req.on_event = None

    def _record_token(self, req: Request, tok: int):
        if req.state.terminal:
            return              # aborted by a callback earlier this step
        req.generated.append(int(tok))
        req.emitted += 1
        if not req.first_token_at:      # TTFT survives preemption
            req.first_token_at = self._now()
        if req.state == RequestState.PREFILLING:
            req.state = RequestState.DECODING
        self.tokens_generated += 1
        self._emit(req, token=int(tok))

    def _complete(self, req: Request):
        self.sched.complete(req, self.cache)
        self._emit(req)

    def _fail(self, req: Request, reason: str):
        if self.sched.fail(req, self.cache, reason):
            self.failed_count += 1
            self._emit(req)

    def _preempt_one(self) -> Optional[Request]:
        """Preempt the youngest runnable sequence; a victim the scheduler
        shed (full waiting queue) is counted and its terminal event
        emitted here."""
        victim = self.sched.preempt_one(self.cache)
        if victim is not None and victim.state.terminal:
            self.shed_count += 1
            self._emit(victim)
        return victim

    # ------------------------------------------------------------- step

    def step(self):
        """Advance every in-flight request one scheduling quantum. Never
        raises on one device: unexpected exceptions land in
        ``internal_errors``. Under a mesh only injected faults do (see
        :meth:`_rank_local`). The sanitizers (``ecfg.sanitize``) run
        outside that backstop: a ``SanitizerError`` means the state is
        already corrupt."""
        self.steps += 1
        self.faults.begin_step(self.steps)
        if self.mesh is not None:
            self._step_now = PM.broadcast_float(self.clock(), self.mesh)
        try:
            self._step_inner()
        except Exception as e:  # noqa: BLE001 — the serving-loop backstop
            if self._rank_local(e):
                raise
            self.internal_errors += 1
            self.last_error = repr(e)
        self._step_now = None
        if self.ecfg.sanitize:
            check_engine(self)
            self.sanitize_checks += 1

    def _rank_local(self, e: Exception) -> bool:
        """Whether ``e`` may have been raised on this rank alone: under a
        mesh, anything but an injected fault (every rank runs the same
        fault schedule and raises it at the same point). Such an
        exception is not swallowed, since the other ranks may be waiting
        in a collective this rank skipped: the rank fails, and
        ``launch.mesh.spawn`` stops the group and raises."""
        return self.mesh is not None and not isinstance(e, InjectedFault)

    def _step_inner(self):
        # expiry runs before admission: a request dead on arrival never
        # acquires pages
        for req in self.sched.expire_deadlines(self.cache, self._now()):
            self.timeout_count += 1
            self._emit(req)
        chunked = self.ecfg.prefill_mode == "chunked"
        nfin = len(self.sched.finished)
        admitted = self.sched.admit(
            self.cache,
            first_chunk_tokens=(self.ecfg.prefill_chunk_tokens if chunked
                                else None),
            prefix_cache=self.ecfg.prefix_caching)
        for r in self.sched.finished[nfin:]:    # prompt_too_long rejections
            self._emit(r)
        self.prefix_hit_tokens += sum(r.cached_tokens for r in admitted)
        # chunk rows and decode rows share one token budget
        n_decode_est = sum(1 for r in self.sched.running
                           if r.prefilled and not r.done)
        budget = max(1, self.ecfg.prefill_chunk_tokens - n_decode_est)
        if self.ecfg.unified:
            self._step_unified(budget)
        else:
            self._step_split(admitted, chunked, budget)
        for req in list(self.sched.running):
            if req.done:
                self._complete(req)

    def _step_unified(self, budget: int):
        """ONE forward for decode rows ∪ prompt chunks; decode slots are
        reserved before the prefill plan (reservation may preempt), and
        the drafts of speculating rows are planned between the two and
        debit the prefill budget."""
        decode = self._reserve_decode_slots(
            [r for r in self.sched.running if r.prefilled and not r.done])
        drafts = self._plan_speculation(decode, budget)
        budget = max(1, budget - sum(len(d) for d in drafts))
        plan = self.sched.plan_prefill(self.cache, budget)
        if not plan and not decode:
            stuck = [r for r in self.sched.running if not r.prefilled]
            if stuck and not any(r.prefilled for r in self.sched.running):
                self._preempt_one()
            return
        if plan and decode:
            self.interleaved_steps += 1
        self._forward_step(plan, list(zip(decode, drafts)))

    def _plan_speculation(self, decode: list[Request],
                          budget: int) -> list[list[int]]:
        """One draft per decode row (``[]``: plain one-token decode). Host
        work only: ask the draft source, clamp k to the tokens the request
        can still commit and to the step budget (one token held back
        while a prompt is mid-stream), check the proposal, and grow the
        row's pages to its k+1-token verify chunk — trimming the draft
        rather than preempting anyone when the pool is short. A raising
        draft source (or an injected ``draft`` fault) degrades to no
        draft and counts ``draft_errors``."""
        drafts: list[list[int]] = [[] for _ in decode]
        if not any(r.params is not None and r.params.speculation > 0
                   for r in decode):
            return drafts
        avail = budget - 1 if any(not r.prefilled
                                  for r in self.sched.running) else budget
        for i, r in enumerate(decode):
            k = r.params.speculation if r.params is not None else 0
            if k <= 0:
                continue
            remaining = r.max_new_tokens - len(r.generated)
            if remaining <= 1:
                # a draft would be rolled back for certain
                self.spec_noop_count += 1
                continue
            k = min(k, remaining - 1, avail)
            if k <= 0:
                continue
            try:
                fault = self.faults.check("draft")
                if fault is not None and fault.action == "raise":
                    raise InjectedFault("draft: injected draft failure")
                d = ([] if fault is not None
                     else list(self.draft_source.draft(
                         r.prompt, r.generated, k))[:k])
                if any(not 0 <= int(t) < self.cfg.vocab_size for t in d):
                    raise ValueError(f"draft token out of vocab: {d}")
            except Exception as e:  # noqa: BLE001 — draft sources are
                # untrusted; degrade to plain decode, never fail the step
                self.draft_errors += 1
                self.last_error = f"draft: {e!r}"
                d = []
            if not d:
                continue
            # pages for the verify chunk (ctx + last token + k drafts)
            ctx = int(self.cache.seq_len[r.seq_slot])
            cap = self.cache.grow_to(r.seq_slot, ctx + 1 + len(d))
            d = [int(t) for t in d[:max(0, cap - ctx - 1)]]
            if d:
                drafts[i] = d
                avail -= len(d)
                self.spec_draft_tokens += len(d)
        return drafts

    def _reserve_decode_slots(self, runnable: list[Request]) -> list[Request]:
        """Page headroom for one decode token per runnable sequence,
        preempting youngest-first; a sequence at ``max_pages_per_seq``
        finishes with ``stop_reason="length_cap"``."""
        pending = list(runnable)
        ready: list[Request] = []
        while pending:
            r = pending.pop(0)
            if r.seq_slot < 0 or r.state.terminal:
                continue
            if self.cache.extend_seq(r.seq_slot):
                ready.append(r)
                continue
            if self.cache.at_capacity(r.seq_slot):
                r.stop_reason = "length_cap"
                self._complete(r)
                continue
            victim = self._preempt_one()
            if victim is None:
                continue
            if victim in pending:
                pending.remove(victim)
            elif victim in ready:
                ready.remove(victim)
            if victim is not r:
                pending.insert(0, r)
        return [r for r in ready if r.seq_slot >= 0 and not r.state.terminal]

    # --------------------------------------------------- unified forward

    def _forward_step(self, plan: list[tuple[Request, int, int]],
                      decode: list[tuple[Request, list]]):
        """Pack prompt-chunk rows and decode rows (each paired with its
        draft, ``[]`` for none) into one ragged forward, then advance host
        state, sample and verify. A forward failure quarantines every
        request of this batch; host state moves only afterwards, so the
        quarantine frees back to baseline. A speculating row is a chunk
        of 1 + k tokens whose every position yields logits; other rows
        yield one (spec-off steps keep the ``[nb, V]`` layout)."""
        rows = list(plan) + [
            (r, int(self.cache.seq_len[r.seq_slot]), 1 + len(d))
            for r, d in decode]
        starts = np.asarray([s for _, s, _ in rows])
        takes = np.asarray([t for _, _, t in rows])
        slots = np.asarray([r.seq_slot for r, _, _ in rows])
        nseq = len(rows)
        cum = np.concatenate([[0], np.cumsum(takes)])
        tok_seq = np.repeat(np.arange(nseq), takes)
        tok_off = np.concatenate([np.arange(t) for t in takes])
        tok_pos = starts[tok_seq] + tok_off
        tokens = np.concatenate(
            [np.asarray(r.prompt[s:s + t]) for r, s, t in plan]
            + [[r.generated[-1]] + d for r, d in decode]).astype(np.int64)
        # logit slots: each row's last token, or every chunk position of
        # a speculating row (verification reads each drafted position)
        nplan = len(plan)
        slot0: list[int] = []
        logit_idx: list[int] = []
        for si in range(nseq):
            slot0.append(len(logit_idx))
            if si >= nplan and takes[si] > 1:
                logit_idx.extend(range(int(cum[si]), int(cum[si + 1])))
            else:
                logit_idx.append(int(cum[si + 1]) - 1)
        # the rows sampled (finished prompts, plain decode) and verified
        need = [(slot0[si], r, len(r.prompt))
                for si, (r, s, t) in enumerate(plan)
                if s + t == len(r.prompt)]
        need += [(slot0[nplan + j], r, r.total_len)
                 for j, (r, d) in enumerate(decode) if not d]
        spec = [(slot0[nplan + j], r, int(starts[nplan + j]), d)
                for j, (r, d) in enumerate(decode) if d]
        try:
            logits = self._guarded_forward(
                plan, starts, takes, slots, cum, tok_seq, tok_off, tok_pos,
                tokens, np.asarray(logit_idx),
                [si for si, _, _ in need] + [s0 for s0, _, _, _ in spec])
        except Exception as e:  # noqa: BLE001 — batch-granular quarantine
            if self._rank_local(e):
                raise
            # drafts die with the batch, counted as rolled back
            self.spec_rollback_tokens += sum(len(d) for _, d in decode)
            for r, _, _ in rows:
                self._fail(r, f"forward: {e!r}")
            return

        for r, s, t in plan:
            r.prefill_pos = s + t
            self.cache.seq_len[r.seq_slot] = r.prefill_pos
            if self.ecfg.prefix_caching and r.prefill_pos == len(r.prompt):
                self.cache.publish_prefix(r.seq_slot, r.prompt)
        # speculating rows land at their verified length (truncate_seq)
        self.cache.advance([r.seq_slot for r, d in decode if not d])

        # a row whose logits are not finite fails; the others sample on
        if need:
            finite = np.isfinite(
                logits[[si for si, _, _ in need]]).all(axis=-1)
            for (_, r, _), ok in zip(need, finite):
                if not ok:
                    self._fail(r, "non_finite_logits")
            need = [t for t, ok in zip(need, finite) if ok]
        if need:
            self._sample_rows(logits, need)
        for s0, r, ctx, d in spec:
            if np.isfinite(logits[s0:s0 + len(d) + 1]).all():
                self._verify_row(logits, s0, r, ctx, d)
            else:
                self.spec_rollback_tokens += len(d)
                self._fail(r, "non_finite_logits")

    def _sample_rows(self, logits: np.ndarray, need: list):
        """One batched sample over ``need`` (logits slot, request,
        position); a sampler failure (or an injected ``sample`` fault)
        fails exactly these rows."""
        try:
            if self.faults.check("sample"):
                raise InjectedFault("sample: injected sampler failure")
            toks = self._sample_batch(
                logits[[si for si, _, _ in need]],
                [r for _, r, _ in need], [p for _, _, p in need])
        except Exception as e:  # noqa: BLE001 — row-granular quarantine
            for _, r, _ in need:
                self._fail(r, f"sample: {e!r}")
            return
        for (_, r, _), tok in zip(need, toks):
            self._record_token(r, tok)

    def _verify_row(self, logits: np.ndarray, s0: int, r: Request,
                    ctx: int, draft: list):
        """Commit one speculating row's verified prefix: ``truncate_seq``
        lands the row at ctx + len(committed) first (retracting rejected
        drafts, advancing over accepted ones), then the tokens emit, so a
        reentrant ``abort()`` from a callback finds the pages consistent.
        A verification failure (or an injected ``verify`` fault) fails
        this request only."""
        if r.seq_slot < 0 or r.state.terminal:
            # aborted earlier in this step: the draft died with its pages
            self.spec_rollback_tokens += len(draft)
            return
        try:
            if self.faults.check("verify"):
                raise InjectedFault("verify: injected verifier failure")
            committed, accepted = self._verify_tokens(logits, s0, r, draft)
            self.cache.truncate_seq(r.seq_slot, ctx + len(committed))
        except Exception as e:  # noqa: BLE001 — row-granular quarantine
            self.spec_rollback_tokens += len(draft)
            self._fail(r, f"verify: {e!r}")
            return
        self.spec_accepted_tokens += accepted
        self.spec_rollback_tokens += len(draft) - accepted
        for tok in committed:
            self._record_token(r, tok)

    def _verify_tokens(self, logits: np.ndarray, s0: int, r: Request,
                       draft: list):
        """Walk the verify chunk's logits → (committed, accepted). Position
        i is conditioned on the last sampled token and drafts 0..i-1.
        Greedy: a draft equal to the row's argmax is accepted, the first
        mismatch commits the argmax and stops. Stochastic: point-mass
        rejection sampling per position (``sampling.reject_sample``).
        After the last accepted draft the next row yields one more token,
        so a verified step commits at least one."""
        p = r.params
        temp = p.temperature if p is not None else self.ecfg.temperature
        top_k = min(p.top_k if p is not None else self.ecfg.top_k,
                    logits.shape[1])
        remaining = r.max_new_tokens - len(r.generated)
        committed: list[int] = []
        accepted = 0
        i = 0
        while i <= len(draft) and len(committed) < remaining:
            row = logits[s0 + i]
            drafted = int(draft[i]) if i < len(draft) else None
            if temp <= 0.0:
                tok = int(np.argmax(row))
                ok = drafted is not None and tok == drafted
            else:
                tok, ok = SMP.reject_sample(row, temp, top_k, drafted,
                                            r.request_id, r.total_len + i)
            committed.append(tok)
            if not ok:
                break
            accepted += 1
            i += 1
        return committed, accepted

    def _guarded_forward(self, plan, starts, takes, slots, cum, tok_seq,
                         tok_off, tok_pos, tokens, logit_idx,
                         consumed) -> np.ndarray:
        """Destinations (the ``append_kv`` fault point), shape buckets,
        counters and the ONE forward (the ``forward`` fault point:
        ``raise`` aborts before it, ``nan`` overwrites the logits slot
        ``consumed[row]`` after it, clamped) → host logits ``[lb, V]``
        f32, one row per entry of ``logit_idx`` (its own bucket ``lb``,
        which is ``nb`` when no row speculates). No scheduler or cache
        bookkeeping moves in here."""
        pages_np, offs_np = self.cache.token_dests_np(slots[tok_seq], tok_pos)
        nseq, ttot = len(starts), int(takes.sum())
        tb = _bucket(ttot, lo=8)
        nb = _bucket(nseq)
        cb = _bucket(int(takes.max()))
        pf_tokens = int(sum(t for _, _, t in plan))
        self.peak_prefill_fp_tokens = max(self.peak_prefill_fp_tokens,
                                          pf_tokens)
        self.prefill_tokens += pf_tokens
        self.forward_calls += 1
        no_history = int(starts.max()) == 0
        hkv = self.cfg.num_kv_heads
        hkv_loc = hkv // self.tp_size     # this rank's kv heads
        # the dense schedule's table width, bucketed like the reference's
        npb = min(_bucket(self.cache.pages_needed(max(int(starts.max()), 1))),
                  self.cache.pcfg.max_pages_per_seq)

        def dev(a, n, fill=0):
            return torch.from_numpy(_pad_to(a, n, fill)).to(self.device)

        attn = {}
        if not no_history:
            self.attn_forwards += 1
            items = int(hkv * (np.sum(
                (starts + self.ecfg.page_size - 1) // self.ecfg.page_size)
                + nseq))
            self.attn_work_items += items
            for i in range(self.tp_size):
                self.attn_work_items_per_shard[i] += items // self.tp_size
            self.attn_dense_grid_items += nb * hkv * (npb + 1)
            if self.ecfg.attention_schedule == "dense":
                # rows [nseq, nb) are q_len-0 padding: page 0, no history
                tables = np.zeros((nb, npb), np.int32)
                tables[:nseq] = self.cache.block_tables_np(slots, npb)
                attn = dict(tables=torch.from_numpy(tables).to(self.device),
                            ctx=dev(starts, nb), qlens=dev(takes, nb))
                self.attn_grid_items += nb * hkv * (npb + 1)
            else:
                # the padding sentinel must clear the BUCKETED row count:
                # rows [nseq, nb) are live (qlen-0) segments in the combine.
                # In exact mode (the card) a verify chunk's query i reads
                # the chunk's earlier KV from the pages written below, as
                # the decode step at ctx + i would; the f32 mode keeps the
                # reference's in-flight reads. Under a mesh the set is
                # built at the local head count and drives every rank
                verify = ((np.arange(nseq) >= len(plan)) & (takes > 1)
                          if self.device.type == "cuda" else None)
                desc_np = self.cache.work_queue_np(slots, starts, takes,
                                                   pad_row=nb * hkv_loc,
                                                   verify=verify,
                                                   num_kv_heads=hkv_loc)
                attn = dict(desc=torch.from_numpy(desc_np).to(self.device),
                            plan=ops.work_plan(
                                desc_np, nb * hkv_loc, cb,
                                self.cfg.num_heads // hkv, self.device))
                self.attn_grid_items += desc_np.shape[0] * self.tp_size

        fault = self.faults.check("forward")
        if fault is not None and fault.action == "raise":
            raise InjectedFault("forward: injected forward failure")
        logits = self._unified_body(
            cb, nb, no_history,
            tokens=dev(tokens, tb), positions=dev(tok_pos, tb),
            # padding tokens: page == num_pages and row == nb, one past
            # the pool and the batch — they land on scratch and are dropped
            pages=dev(pages_np, tb, self.cache.pcfg.num_pages),
            offs=dev(offs_np, tb), tseq=dev(tok_seq, tb, nb),
            toff=dev(tok_off, tb),
            # decode tokens (the packed tail) read their in-flight KV
            # fake-quantized, the values their int4 page dequantizes to
            dq_mask=dev(np.arange(ttot) >= cum[len(plan)], tb),
            last_idx=dev(logit_idx, _bucket(len(logit_idx))),
            **attn).cpu().numpy()
        if fault is not None and len(consumed):
            # the injected NaN lands on a row the caller consumes
            logits[consumed[min(fault.row, len(consumed) - 1)]] = np.nan
        return logits

    @torch.no_grad()
    def _unified_body(self, cb: int, nb: int, no_history: bool, *, tokens,
                      positions, pages, offs, tseq, toff, dq_mask, last_idx,
                      desc=None, plan=None, tables=None, ctx=None,
                      qlens=None) -> torch.Tensor:
        """The forward over the packed ``[1, Tb]`` stream → f32 logits, one
        row per packed token index in ``last_idx`` (each row's last token,
        or every position of a verify chunk). Attention takes
        the work-queue descriptors ``desc`` (and their host-built
        ``ops.work_plan``), or the dense schedule's ``tables`` with per-row
        ``ctx``/``qlens``. Under a mesh: this rank's heads, and the two
        seams of each layer."""
        cfg, params, quant, cache = self.cfg, self.params, self.quant, \
            self.cache
        mesh = self.mesh
        hq_loc = cfg.num_heads // self.tp_size
        hkv_loc = cfg.num_kv_heads // self.tp_size
        scales = (cache.k_scale, cache.k_zero, cache.v_scale, cache.v_zero)
        gseq = tseq.clamp(max=nb - 1)          # JAX clamps this gather
        dq = (dq_mask != 0)[None, :, None, None]

        def pad(a):    # packed [1, Tb, H, D] → [nb, cb, H, D]
            # padding tokens (row nb) land on a scratch row past the batch
            z = torch.zeros((nb + 1, cb) + tuple(a.shape[2:]), dtype=a.dtype,
                            device=a.device)
            z[tseq, toff] = a[0]
            return z[:nb]

        x = self.lm.embed(params, tokens[None, :])
        pos2 = positions[None, :]
        for li, bp in enumerate(params["blocks"]):
            h = C.apply_norm(bp["attn_norm"], x, cfg.norm, cfg.norm_eps)
            q, k, v = ATT.project_qkv(bp["attn"], cfg, h, pos2, quant,
                                      num_heads=hq_loc, num_kv_heads=hkv_loc)
            kq, vq = Q.quantize_kv_with(k, v, *scales)  # [1, Hkv, Tb, D/2]
            cache.write_kv(li, pages, offs, kq[0].transpose(0, 1),
                           vq[0].transpose(0, 1))
            kdq, vdq = Q.qdq_kv_with(k, v, *scales)
            k_att = torch.where(dq, kdq, k.float())
            v_att = torch.where(dq, vdq, v.float())
            if no_history:
                out = ATT.flash_attention(pad(q), pad(k_att), pad(v_att))
            elif tables is None:
                out = ops.paged_kv4_prefill_attention_wq(
                    pad(q), pad(k_att), pad(v_att),
                    cache.k_pool[li], cache.k_scale, cache.k_zero,
                    cache.v_pool[li], cache.v_scale, cache.v_zero,
                    desc, plan=plan, impl=quant.impl)
            else:
                out = ops.paged_kv4_prefill_attention(
                    pad(q), pad(k_att), pad(v_att),
                    cache.k_pool[li], cache.k_scale, cache.k_zero,
                    cache.v_pool[li], cache.v_scale, cache.v_zero,
                    tables, ctx, qlens, impl=quant.impl)
            a = out[gseq, toff][None].to(x.dtype).reshape(
                1, -1, hq_loc * cfg.head_dim)
            x = x + _row_linear(bp["attn"]["wo"], a, quant, mesh)
            h = C.apply_norm(bp["mlp_norm"], x, cfg.norm, cfg.norm_eps)
            if "moe" in bp:         # under a mesh refused (_init_sharding)
                x = x + MLP.moe_apply(bp["moe"], h, cfg, quant,
                                      self.moe_dropped)[0]
            else:
                x = x + _mlp_row(bp["mlp"], h, quant, cfg.mlp_act, mesh)
        h = C.apply_norm(params["final_norm"], x[:, last_idx], cfg.norm,
                         cfg.norm_eps)
        return self.lm.head(params, h)[0]

    # ----------------------------------------- split-step baselines

    def _step_split(self, admitted: list[Request], chunked: bool,
                    budget: int):
        """[Baseline] the two-forward step: a prefill forward (the planned
        chunks, or each newly admitted whole prompt), then a separate
        decode forward. Prefill is planned BEFORE decode slots are
        reserved, the reverse of the unified step, so a reservation can
        preempt a request that prefilled in this very step."""
        if chunked:
            plan = self.sched.plan_prefill(self.cache, budget)
            if plan:
                self._prefill_forward(plan)
            else:
                stuck = [r for r in self.sched.running if not r.prefilled]
                if stuck and not any(r.prefilled
                                     for r in self.sched.running):
                    self._preempt_one()
            prefill_ran = bool(plan)
        else:
            for req in admitted:
                self._prefill(req)
            prefill_ran = bool(admitted)
        runnable = self._reserve_decode_slots(
            [r for r in self.sched.running if r.prefilled and not r.done])
        if runnable:
            self._decode_batch(runnable)
            if prefill_ran:
                self.interleaved_steps += 1

    def _sample_batch(self, logits: np.ndarray, reqs: list[Request],
                      positions: list[int]) -> list[int]:
        """One token per row of ``logits`` ``[n, V]``, each row under its
        request's own temperature and top_k, keyed by (request id,
        ``positions``); an all-greedy batch is one argmax."""
        dflt = self.ecfg
        temps = np.asarray(
            [r.params.temperature if r.params else dflt.temperature
             for r in reqs], np.float32)
        if (temps <= 0.0).all():
            return [int(t) for t in np.argmax(logits, axis=-1)]
        topks = [r.params.top_k if r.params else dflt.top_k for r in reqs]
        return [int(t) for t in SMP.sample_batch(
            logits, [r.request_id for r in reqs], positions, temps, topks)]

    def _layers(self, x, positions, attend):
        """Every layer around ``attend(li, q, k, v)`` → the attention
        output ``[..., Hq, D]`` (the config's norm, q/k/v with RoPE, wo,
        the config's MLP) → the last hidden state."""
        cfg, quant = self.cfg, self.quant
        for li, bp in enumerate(self.params["blocks"]):
            h = C.apply_norm(bp["attn_norm"], x, cfg.norm, cfg.norm_eps)
            q, k, v = ATT.project_qkv(bp["attn"], cfg, h, positions, quant)
            a = attend(li, q, k, v).to(x.dtype).reshape(*x.shape[:2],
                                                         cfg.q_dim)
            x = x + C.linear(bp["attn"]["wo"], a, quant)
            h = C.apply_norm(bp["mlp_norm"], x, cfg.norm, cfg.norm_eps)
            if "moe" in bp:
                x = x + MLP.moe_apply(bp["moe"], h, cfg, quant,
                                      self.moe_dropped)[0]
            else:
                x = x + MLP.mlp_apply(bp["mlp"], h, quant, cfg.mlp_act)
        return x

    def _logits(self, x) -> np.ndarray:
        h = C.apply_norm(self.params["final_norm"], x, self.cfg.norm,
                         self.cfg.norm_eps)
        return self.lm.head(self.params, h).cpu().numpy()

    @torch.no_grad()
    def _prefill(self, req: Request):
        """[Baseline] whole-prompt prefill: one fp causal forward over the
        prompt; each layer writes the prompt's int4 KV into its pages."""
        t = len(req.prompt)
        self.peak_prefill_fp_tokens = max(self.peak_prefill_fp_tokens, t)
        self.prefill_tokens += t
        self.forward_calls += 1
        tokens = torch.tensor(req.prompt, dtype=torch.int64,
                              device=self.device)[None]
        positions = torch.arange(t, device=self.device)[None]

        def attend(li, q, k, v):
            self.cache.write_prompt(li, req.seq_slot, k, v)
            return ATT.flash_attention(q, k, v)

        x = self._layers(self.lm.embed(self.params, tokens), positions,
                         attend)
        tok = self._sample_batch(self._logits(x[:, -1:])[0], [req],
                                 [t])[0]
        self.cache.extend_seq(req.seq_slot)
        req.prefill_pos = t
        self._record_token(req, tok)

    @torch.no_grad()
    def _prefill_forward(self, plan: list[tuple[Request, int, int]]):
        """[Baseline] ONE ragged forward over the planned prompt chunks and
        no decode rows. Per layer the chunk's raw k/v is quantized into
        the pools first; attention then reads the fp chunk queries against
        the int4 history through block tables (the dense kernel) plus the
        chunk's own fp k/v, or plain fp causal attention when no row has
        history. Logits only for prompts that finish here."""
        cache, dev = self.cache, self.device
        starts = np.asarray([s for _, s, _ in plan])
        takes = np.asarray([t for _, _, t in plan])
        slots = np.asarray([r.seq_slot for r, _, _ in plan])
        nseq, cmax, ttot = len(plan), int(takes.max()), int(takes.sum())
        cum = np.concatenate([[0], np.cumsum(takes)])
        tok_seq = np.repeat(np.arange(nseq), takes)
        tok_off = np.concatenate([np.arange(t) for t in takes])
        tok_pos = starts[tok_seq] + tok_off
        tokens = np.concatenate(
            [r.prompt[s:s + t] for r, s, t in plan]).astype(np.int64)
        pages, offs = cache.token_dests(slots[tok_seq], tok_pos)
        tables = cache.block_tables_device(slots, max(int(starts.max()), 1))
        ctx = torch.from_numpy(starts).to(dev)
        qlens = torch.from_numpy(takes).to(dev)
        tseq = torch.from_numpy(tok_seq).to(dev)
        toff = torch.from_numpy(tok_off).to(dev)
        # equal takes: the packed layout IS the padded one
        uniform = bool((takes == takes[0]).all())
        no_history = int(starts.max()) == 0
        self.peak_prefill_fp_tokens = max(self.peak_prefill_fp_tokens, ttot)
        self.prefill_tokens += ttot
        self.forward_calls += 1

        def pad(a):            # [1, Ttot, H, D] → [nseq, Cmax, H, D]
            if uniform:
                return a[0].reshape(nseq, cmax, *a.shape[2:])
            z = a.new_zeros((nseq, cmax) + tuple(a.shape[2:]))
            z[tseq, toff] = a[0]
            return z

        def attend(li, q, k, v):
            cache.scatter_tokens(li, pages, offs, k, v)
            if no_history:
                out = ATT.flash_attention(pad(q), pad(k), pad(v))
            else:
                out = ops.paged_kv4_prefill_attention(
                    pad(q), pad(k), pad(v),
                    cache.k_pool[li], cache.k_scale, cache.k_zero,
                    cache.v_pool[li], cache.v_scale, cache.v_zero,
                    tables, ctx, qlens, impl=self.quant.impl)
            return (out.reshape(1, ttot, *out.shape[2:]) if uniform
                    else out[tseq, toff][None])

        x = self._layers(
            self.lm.embed(self.params, torch.from_numpy(tokens).to(dev)[None]),
            torch.from_numpy(tok_pos).to(dev)[None], attend)
        finished = [(si, r) for si, (r, s, t) in enumerate(plan)
                    if s + t == len(r.prompt)]
        if finished:
            logits = self._logits(x[:, [int(cum[si + 1] - 1)
                                        for si, _ in finished]])[0]
        for r, s, t in plan:
            r.prefill_pos = s + t
            cache.seq_len[r.seq_slot] = r.prefill_pos
            if self.ecfg.prefix_caching and r.prefill_pos == len(r.prompt):
                cache.publish_prefix(r.seq_slot, r.prompt)
        if finished:
            toks = self._sample_batch(logits, [r for _, r in finished],
                                      [len(r.prompt) for _, r in finished])
            for (_, r), tok in zip(finished, toks):
                self._record_token(r, tok)

    @torch.no_grad()
    def _decode_batch(self, reqs: list[Request]):
        """[Baseline] the separate decode forward. Each layer writes the
        new token's int4 KV into the pools BEFORE attention, over lengths
        seq_len + 1, so decode reads its own token back as int4 (the
        unified step fake-quantizes it in flight instead)."""
        cache, dev, hkv = self.cache, self.device, self.cfg.num_kv_heads
        ps = self.ecfg.page_size
        slots = [r.seq_slot for r in reqs]
        bsz = len(reqs)
        lengths_np = cache.seq_len[slots].copy()
        max_len = int(lengths_np.max()) + 1
        paged = self.ecfg.decode_attention == "paged"
        lengths = torch.from_numpy(lengths_np + 1).to(dev)
        pages, offs = cache.token_dests(slots, lengths_np)
        self.forward_calls += 1
        npages = cache.pages_needed(max_len)
        if paged:
            self.attn_forwards += 1
            self.attn_work_items += int(hkv * np.sum((lengths_np + ps) // ps))
            self.attn_dense_grid_items += bsz * hkv * npages
            if self.ecfg.attention_schedule == "work_queue":
                # the batch attends over ctx + this step's token: the
                # descriptors cover exactly those real pages
                desc_np = cache.work_queue_np(slots, lengths_np + 1)
                desc = torch.from_numpy(desc_np).to(dev)
                plan = ops.work_plan(desc_np, bsz * hkv, 1,
                                     self.cfg.num_heads // hkv, dev)
                self.attn_grid_items += desc_np.shape[0]
            else:
                tables = cache.block_tables_device(slots, max_len)
                self.attn_grid_items += bsz * hkv * npages
        else:
            # the scales broadcast to the batch, as views
            ks, kz, vs, vz = [
                torch.broadcast_to(s[None], (bsz,) + tuple(s.shape))
                for s in (cache.k_scale, cache.k_zero, cache.v_scale,
                          cache.v_zero)]

        def attend(li, q, k, v):
            cache.scatter_tokens(li, pages, offs, k, v)   # before attention
            q = q[:, 0]
            if not paged:
                kp, vp, _ = cache.gather_kv(li, slots, max_len)
                return ops.kv4_decode_attention(
                    q, kp, ks, kz, vp, vs, vz, lengths, impl=self.quant.impl)
            if self.ecfg.attention_schedule == "work_queue":
                return ops.paged_kv4_decode_attention_wq(
                    q, cache.k_pool[li], cache.k_scale, cache.k_zero,
                    cache.v_pool[li], cache.v_scale, cache.v_zero, desc,
                    plan=plan, impl=self.quant.impl)
            return ops.paged_kv4_decode_attention(
                q, cache.k_pool[li], cache.k_scale, cache.k_zero,
                cache.v_pool[li], cache.v_scale, cache.v_zero, tables,
                lengths, impl=self.quant.impl)

        last = torch.tensor([[r.generated[-1]] for r in reqs],
                            dtype=torch.int64, device=dev)
        x = self._layers(self.lm.embed(self.params, last),
                         torch.from_numpy(lengths_np).to(dev)[:, None],
                         attend)
        logits = self._logits(x)[:, -1]
        cache.advance(slots)
        toks = self._sample_batch(logits, reqs, [r.total_len for r in reqs])
        for r, tok in zip(reqs, toks):
            self._record_token(r, tok)
