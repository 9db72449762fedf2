#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printed on its own lines; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``) and the
   build of every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together);
2. kernels: each kernel against its plain PyTorch version on the card at
   the Llama-3-8B widths — the fused act-quant (K1 and K2 in one launch
   on bf16 input; K = 4,096 and 14,336, M ∈ {1, 8, 16, 256}, a strided
   view; K1 and K2 alone too) byte-exact, one launch a call, timed per
   call and as 100 calls between one event pair beside the parent's
   route (two f32 copies + K1 + K2), the W4Ax GEMMs (W4A4, W4A8 and
   the mixed kernel, which adds ``(d·a_s)·w_s`` in its plain version's
   order) bit for bit at M ∈ {1, 8, 16, 256} (K3, K4 also at Llama-3-70B's
   FFN widths and Qwen2-72B's down projection, M ∈ {8, 256}, timed
   under ``archs``), the attention kernels
   (work-queue and dense prefill, paged dense and work-queue decode,
   contiguous decode) on real cache states with ragged lengths,
   zero-history and q_len-0 rows: each computes exactly as its plain
   version does on the card (f64 sums rounded once) and must agree bit
   for bit on the valid rows — with
   CUDA-event times (median of 20) of kernel, plain version, a library
   yardstick (bf16 ``torch.matmul`` on dequantized weights, SDPA on
   gathered dequantized KV) and the roofline bound (for the mixed kernel
   also the split pair on the same inputs as ``split_ms``); the GEMMs are
   timed at M = 256 and, under their row's ``decode`` key, M = 8, and both
   prefill attention ops (K7 dense, K9 work queue — the whole op, which
   must run in at most two kernel launches, counted by
   ``torch.profiler``) at C = 256 and, under ``decode``, at C = 1 on the
   decode kernels' inputs; the work-queue decode op (K8) is the whole op
   in one launch, counted the same way; K6, K8, K10 and K9 (C = 1) again
   at GQA groups 5 and 12 on 40/8- and 48/4-head decode batches, K9 at
   G = 12 and C = 256 (under ``G=5``, ``G=12``, ``G=12 C=256``), and K9
   at speculative decode's verify shape, the decode batch's rows each a
   chunk of 5 queries padded to 8 whose KV is in its pages (under ``C=5
   spec``: the verify layout the engine uses on the card, each position
   bit for bit the decode step of its token, and the parent's layout
   timed beside it); K6–K10 again at head_dim 32, 64 and 80 at GQA groups
   1, 2, 4 and 8 on 8 kv heads (entries ``D=<d> Hq=32`` — timed, the
   8B's heads — and ``D=<d> G=<g>``, each with ``C=1`` and ``C=256``),
   and head_dim 96, a width not built, refused;
3. parity: three 2-layer d_model-1024 models (Llama-shaped; Qwen2.5-
   shaped, 10/2 heads, QKV bias; StarCoder2-shaped, 12/1 heads, QKV bias,
   LayerNorm, GELU; biases seeded non-zero) served on the card in every
   engine configuration (the unified step under both attention
   schedules, the split step under both and under the work queue with
   pages of 128 keys, whole-prompt prefill with gather decode, the
   unified step under the mixed W4Ax schedule, the unified step with every
   request sampled at T = 0.8 from its top 40 with 4 drafts a decode row),
   twice each, with the kernels and with ``impl="ref"``: first logits to
   2e-2·max|logit|, token agreement ≥ 0.9, drafted = accepted + rolled
   back;
4. slice: Llama-3-8B at full width and depth (random seeded weights),
   default ``EngineConfig`` but ``prefill_chunk_tokens=256``, 8 requests
   of 128–512 prompt tokens × 32 new tokens, greedy, to completion; every
   request must finish with 32 tokens, no failed or internal errors,
   every kernel of the path must have launched (launch counts reset just
   before), the fused act-quant exactly 4 × 32 × forwards times (one per
   distinct projection input) and K1, K2 alone never;
5. baselines: the same weights and workload served in the reference's
   measured baselines — (a) split step, work queue; (b) split step,
   dense; (c) whole-prompt prefill, gather decode; (d) unified step,
   dense; (e) the default step under the paper's mixed W4Ax schedule —
   with the same checks, each run launching its own kernels ((e) the
   mixed GEMM and never the W4A4/W4A8 pair);
6. spec: Llama-3-8B at full width and depth, 8 requests whose prompts
   repeat one seeded 24-token pattern up to 128–512 tokens × 32 new
   tokens, ``prefill_chunk_tokens=256``, the sanitizers on, served (a)
   greedy, (b) greedy with 4 drafts a row, (c) at T = 0.8, top_k 40 with
   3 drafts, twice, and (d) as (b) under an injected schedule (a raising
   draft source, a failing verification, NaN logits), then (a) and (b)
   under the dense attention schedule: no internal error, a sanitizer
   pass every step, the pages back to the pool, the path's kernels
   launched; (b) accepts drafts in fewer forwards than (a) and emits
   (a)'s tokens, every one; (c) replays its tokens, (d) fails exactly the
   requests its faults hit; (b dense)'s agreement with (a dense) printed;
7. recover (Llama-3-8B at full width and 8 of its 32 layers): the spec
   workload greedy with 4 drafts and at T = 0.8, each
   through a directory-backed ``RecoveryLog(snapshot_every=4)`` stopped
   two steps past a checkpoint after the first drafts, the engine
   dropped and rebuilt with
   ``RecoveryLog.open_dir``: no replay mismatch, replayed events, the
   uninterrupted run's tokens, pages back; a torn ``snapshot_write``
   leaves the last good snapshot, which resumes to the same tokens; the
   snapshot's bytes and seconds printed; then the greedy run through the
   log over a tensor-parallel mesh of 1 rank (and of 2 where two cards
   exist), spawned through the real NCCL group: crashed and resumed with
   every delivered stream the uninterrupted mesh run's, and torn and
   resumed to its tokens;
8. replicas (the same 8 layers): two replicas on the card (one set of
   weights) serving the spec workload without a crash, then with replica
   1 killed before its 6th step under ``standby`` (the crash-free
   group's tokens) and ``migrate`` (one terminal and 32 tokens per
   request, work moved); peak device memory printed; where four cards
   exist, the group over two meshes of two ranks (NCCL) under both
   policies, every rank's streams and counts those of the group on one
   card under ``serial_seams(2)`` (else "not run");
9. archs: Llama-3-70B at full width and depth (80 layers) serving the
   ``slice`` workload with its checks (the fused act-quant exactly 4 × 80
   × forwards times), after the time to make its weights, the packed
   model's bytes against the ≈ 40.5 GB reckoned by hand and the peak
   device memory; then Mistral-NeMo-12B, Qwen2-72B, Qwen2.5-32B (G = 5,
   QKV bias) and StarCoder2-15B (G = 12, QKV bias, LayerNorm, tanh-GELU)
   at full width and 4 layers, biases and LayerNorm parameters seeded
   non-zero, each serving the same workload (Qwen2.5-32B and
   StarCoder2-15B also in baselines a, b and c: every decode kernel at G
   = 5 and 12; the attention kernels are also checked at G = 16,
   Qwen3-MoE's 64/4 heads, in the kernels phase);
10. tp: tensor parallelism, one spawned process per card (NCCL), at
   every world size of 1, 2 and 4 the visible cards allow (the others
   named on a printed line). Each rank makes its shard of the seeded
   Llama-3-8B weights block by block and serves the ``slice`` workload
   with the sanitizers on (after every step the ranks' tokens and
   scheduler state must agree). World size 1 goes through the real
   process group and seams and must equal the unsharded engine bit for
   bit (tokens and first logits) in the default configuration. For each
   world size M > 1 the cards give, the unsharded engine also serves
   (a), (a2) and (b) below under ``serial_seams(M)`` (wo and w_down as M
   K-slices of the whole weights summed in rank order), its token
   agreement with the plain unsharded runs and first-logit gap printed,
   and every 8B run at M ranks must equal that serial run bit for
   bit, tokens and first logits: (a) at ``int4_fraction=1.0`` and (a2),
   the same at 2 layers, the token agreement with one device and the
   largest first-logit difference, (b) the default configuration's
   tokens/s, median step, peak memory per card and kernel
   launch calls per step per rank (``torch.profiler`` over steps 5–12),
   the seam (all-gather of f32 partials and a rank-order sum) beside
   NCCL's ``all_reduce`` at 8B and 70B widths, then (c) Llama-3-70B at
   full width and depth over the largest mesh, and the cli phase's first
   launcher call with ``--mesh 1x4``. The kernels phase holds
   the fused act-quant, K3 and K4 at one rank's shapes under 4-way
   parallelism (Llama-3-8B and -70B: wq, wk, wo, w_up, w_down shards)
   and K9 and K7 at its local heads (``TP4 8B``: 8/2, ``TP4 70B``:
   16/2), timed at the down projection's shard.
   ``python3 chip_smoke.py --phases tp`` on a host with four cards runs
   it over four cards;
11. cli: the serve launcher (``python -m repro_torch.launch.serve``) in a
   subprocess on Llama-3-8B at full width and depth under the mixed
   schedule, 8 requests of 384–640 prompt tokens (128 shared) × 32 new
   tokens with a 6-deep waiting queue and every 4th request aborted: 2
   must be rejected (``queue_full``), 1 aborted and 5 finish with 32
   tokens, with no failed step, internal or callback error; then again
   with ``--temperature 0.8 --top-k 40 --speculation 3 --sanitize``: the
   same counts, the speculation line (drafted = accepted + rolled back)
   and a sanitizer check every step; then with ``--replicas 2 --failover
   standby --kill-replica-at 6 --snapshot-every 4``: one failover, replica
   0 promoted, all 8 requests finished with 32 tokens; then the smoke
   configuration (head_dim 32) with ``--impl cuda``, through the
   attention kernels: 4 requests finished with 8 tokens each.

12. moe (run after tp, before archs): (a) the expert-batched W4Ax GEMMs
   (K3 and K4, the split pair, and K5; one launch for all experts) at
   Moonlight-16B-A3B's (E = 64) and Qwen3-MoE-235B-A22B's (E = 128)
   expert shapes, capacities 4 to 240, each ``torch.equal`` to its plain
   version and to a loop of the single-expert kernel, timed beside a
   bf16 ``torch.bmm`` and its bound (rows ``*_experts`` of the kernel
   table); (b) both configurations at full width and 2 layers served
   with the kernels and with ``impl="ref"``: the same tokens, first
   logits with error 0 and the same (token, expert) pairs dropped by
   capacity, which must drop some; (c) Moonlight-16B-A3B at full width
   and depth (48 layers) on the ``slice`` workload, with its launch
   calls a step, peak memory and packed bytes, and again under W4A16
   (``weight_only``) at its first 24 layers; (d) Qwen3-MoE at full width
   and 4 of its 94 layers (the depth printed with every number), the
   same (the two cuts, 48 → 24 and 8 → 4 layers, pay for the train
   phase's mesh form); (e) W4A16 on
   Llama-3-8B; tokens/s of every run printed with the card's name and
   power limit.

13. generate (after moe): the model's own path (``LM.prefill``/
   ``decode`` over the contiguous caches, not the engine) on Llama-3-8B
   at full width and depth with the ``slice`` weights:
   ``init_cache(8, 1024)`` with the int4 cache, 8 prompts × 512 tokens
   prefilled, 32 greedy decode steps; K10 must launch 32 × 32 times, the
   fused act-quant 4 × 32 a forward, K1 and K2 alone never, every logit
   finite; tokens/s, the median decode step and peak memory printed; K10
   held bit for bit and timed on that cache (T = 1,024, rows at 512–544
   keys; the K10 row's ``generate T=1024`` entry and
   ``launches_generate``); then at 2 layers the same run with the
   kernels and with ``impl="ref"``, under the int4 cache and the bf16
   one (no K10): the same tokens and logits with error 0;
14. fmpq (after generate): (a) at Llama-3-8B's four projection shapes
   and M ∈ {8, 256}, on activations whose channel scales follow
   ``benchmarks/fmpq_ratio.py``'s synthetic LLM-like regime (8–64
   outlier channels ×80): ``plan_fmpq`` → ``quantize_linear`` →
   ``qlinear_apply`` with the kernels ``torch.equal`` to ``impl="ref"``,
   the plan's INT4 fraction, the error against float64 of FMPQ and of
   the unpermuted fraction path at the same fraction (FMPQ's below 0.8×
   on the activation side, against each path's dequantized weights),
   the gather + fused act-quant beside the fused act-quant alone (the K1
   row's ``perm`` entries); (b) Llama-3-8B with 24 seeded channels of
   every norm scale ×50, calibrated block by block on 4 × 256 seeded
   tokens, planned (q/k/v and up/gate; wo and w_down unplanned): the
   plans' INT4 fractions, the first-logit error against the fp model of
   the planned and the unplanned W4Ax model, and of the unplanned
   weights under W4A8 and W4A16 (the weights' own share), at 1, 2, 4
   and 8 layers of full width, the planned model at full depth on ``slice`` with its
   checks and its launch calls a step beside the ``slice`` weights', and
   at 2 layers
   the planned model served with the kernels and with ``impl="ref"``
   (agreement 1.0000, first logits error 0).

15. families (after fmpq): the other model families through ``LM`` on
   the card, each run's launch counts set to 0 just before it and read
   just after: Zamba2-2.7B (54 Mamba2 layers, 9 shared-attention
   calls at head_dim 80) and RWKV6-1.6B (24 layers) at full width and
   depth, and Llama-3.2-Vision-90B at full width and 10 of its 100
   layers (2 groups of 4 self layers and a cross layer over 1,601 seeded
   image embeddings per request, gates 0.5), each ``prefill`` of 8 × 512
   tokens into a 1,024-slot int4 cache then 32 greedy decode steps
   (prefill ms, median decode step, decode tok/s, peak memory; K10 once
   per attention layer a step: 9 × 32 at D = 80, none for RWKV; the
   fused act-quant per layer kind and forward); HuBERT-XLarge's 48-layer
   encoder over 8 × 512 seeded frames (``train_logits`` ms, peak
   memory); then each family at 2 layers (one group) with the kernels
   and with ``impl="ref"``: logits error 0, greedy agreement 1.0000. The
   kernels phase holds K10 at D = 80 (Zamba2's B = 8, 32/32 heads, T =
   1,024 holding 512–544 keys; the K10 row's ``D=80`` entry, its
   launches from the Zamba2 run).
16. train (after families, before archs): training, which launches none
   of the port's kernels (fp params; the counts set to 0 before (a)'s
   8-layer run and read after it must all be 0): (a) this process as the
   one rank of a real NCCL process group (a 1 × 1 mesh): at Llama-3-8B's
   full width and 2 layers the mesh's ``make_train_step(mesh=)`` and the
   plain ``make_train_step``, 2 steps each at 8 × 1,024 tokens of the
   launcher's synthetic stream, must agree bit for bit (every step's
   metrics, every param and both AdamW moments); then 8 of the 32 layers
   (f32 params, gradients and both moments, 44.7 GB; full depth would
   need 128.5 GB on one card) through the mesh, 2 steps, two loss chunks
   of 512, AdamW at lr 3e-4, weight decay 0.1, a cosine schedule with
   warm-up 1: each step's loss, grad norm and ms, tokens/s, peak memory,
   and a 3rd step under ``torch.profiler`` (launch calls, busy share,
   top kernels, device time by kind); every loss finite and the last
   below the first; (b) one train step of each family's smoke model on
   the card and on the CPU from the same fp params and batch: loss, grad
   norm, AdamW's first moment leaf by leaf and the moved params within
   ``TRAIN_TOL``, the MoE's routing agreement printed; (c) the training
   launcher in a subprocess for 8 steps with a checkpoint every 4, then
   a second process resumed from step 4's checkpoint: the same step 4–7
   lines and final checkpoint, bit for bit. With four cards (else "not
   run"; ``python3 chip_smoke.py --phases train`` on a four-card host):
   (i) at Llama-3-8B width and 2 layers the meshes 2 × 2, 1 × 4 and
   4 × 1, and Moonlight-16B-A3B's width at 1 × 4 (16 of its 64 experts a
   rank), 2 steps each over four spawned ranks (NCCL), every rank's
   metrics and the digest of each of its params and moments equal to
   ``parallel.mesh.serial_train`` (the same mesh as threads on card 0);
   (ii) Llama-3-8B at all 32 layers over 2 × 2, 8 × 1,024 tokens, 4
   AdamW steps: step ms, tokens/s, peak memory per card (< 80 GB), the
   collectives beside NCCL's own (the seam beside ``all_reduce``, the
   FSDP gather beside ``all_gather_into_tensor``, the gradient's
   all-to-all and rank-order sum beside ``reduce_scatter_tensor``), the
   last step profiled on rank 0, every loss finite and every replicated
   leaf identical on the ranks that hold it; (iii) the checkpoint written
   from (ii) after step 2 (the params and AdamW state, or the params
   alone where the disk cannot hold 96 GB) restored over 1 × 4, every
   leaf gathered whole equal to the saved array bit for bit; (iv) the
   launcher with ``--data 2 --model 2``, resumed from its own
   checkpoint bit for bit, as (c);

``--phases times`` (not among the defaults) prints unchecked times of
one projection input's act-quant (``ops.act_quant`` per channel range,
and the fused op where the tree has it), the dense K3, K4 and K5 at
three Llama-3-8B shapes, K9's op (C = 256, C = 1), K6,
K8's op and K10 on the kernels phase's inputs through the API every tree
of the port has, to time two trees in turns in one call.
``--profile`` adds to each Llama-3-8B run a ``torch.profiler`` breakdown,
with the kernel launch calls per engine step.
``--phases famprof`` (not among the defaults) breaks a decode step of
Zamba2-2.7B, RWKV6-1.6B and Llama-3.2-Vision (10 layers) down, on the
``families`` phase's models and prompts: the median step, the aten ops
one step dispatches and the bytes of the f64 tensors they write, and a
``torch.profiler`` trace of 3 steps (device busy share, launch calls a
step, top kernels and host ops). It calls only ``LM``, so two trees of
the port that serve these families can be compared in one call.

Each phase prints its seconds (``[time]``). The last two lines are the
kernel table and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
PHASES = ("kernels", "parity", "slice", "baselines", "spec", "recover",
          "replicas", "tp", "moe", "generate", "fmpq", "families", "train",
          "archs", "cli")
EXTRA_PHASES = ("times", "specdiag", "famprof")     # only when named
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core peak
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores
SLEEP_CYCLES = 100_000_000       # ~50 ms of the card's clock: the host
                                 # queues the timed runs meanwhile


def fail(msg: str):
    print(f"[FAIL] {msg}", flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` runs.

    Every run is queued behind a sleeping kernel, so each event pair times
    the card's work and not the host's Python dispatch (which takes longer
    than a small kernel). A host sync inside ``fn`` would let the host's
    time after it into that run; nothing timed here has one."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def time_ms_100(torch, fn, calls: int = 100, warmup: int = 3) -> float:
    """CUDA-event time of ``calls`` runs of ``fn`` back to back between
    one event pair, ÷ ``calls``: for work shorter than one event pair's
    own floor. Queued behind a sleeping kernel, as in :func:`time_ms`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


# --------------------------------------------------------------- phase 2

# (K, k4) of the Llama-3-8B projections at int4_fraction 0.875: q/k/v, wo
# and up/gate read K = 4,096, down reads K = 14,336
ACT_SHAPES = ((4096, 3584), (14336, 12544))
# (K, k4) of the other dense configurations' projections: d_model 5,120,
# 6,144 and 8,192, d_ff 24,576, 27,648, 28,672 and Qwen2-72B's 29,568
# (231 blocks: an odd 202 int4 + 29 int8)
ARCH_ACT_SHAPES = ((5120, 4480), (6144, 5376), (8192, 7168), (24576, 21504),
                   (27648, 24192), (28672, 25088), (29568, 25856))
ACT_M = (1, 8, 16, 256)
ACT_PER_LAYER = 4      # h (q/k/v), attention output (wo), h (up/gate), down


def act_input(torch, gen, m: int, k: int, k4: int):
    """bf16 activations, as the projections hand them over, with a block
    in each range whose scale is exactly 1 holding every odd multiple of
    0.5 (rounding ties, half to even) and an all-zero block."""
    x = torch.randn((m, k), generator=gen, device="cuda") * 3
    tie = ((torch.arange(128, device="cuda") % 15) - 7) * 0.5
    for lo, qmax in ((0, 7.0), (k4, 127.0)):
        x[0, lo:lo + 128] = tie
        x[0, lo] = qmax
    x[-1, -128:] = 0.0
    return x.bfloat16()


def parent_route(torch, AQ, x, k4: int):
    """The parent's act-quant of one projection, on the same bf16 input
    and with this tree's kernel: an f32 copy of each channel range, then
    one single-range launch each (K1, K2)."""
    a4, s4 = AQ.act_quant_int4(x[:, :k4].to(torch.float32).contiguous())
    a8, s8 = AQ.act_quant_int8(x[:, k4:].to(torch.float32).contiguous())
    return a4, s4, a8, s8


def act_bytes(m: int, k: int, k4: int, in_bytes: int = 2) -> int:
    """The input read once; the int4 and int8 codes and the f32 scales
    written once."""
    return (m * k * in_bytes + m * k4 // 2 + m * (k - k4)
            + m * (k // 128) * 4)


def act_times(torch, AQ, x, k4: int) -> dict:
    """The fused op, the parent's route and the plain version on ``x``,
    each event-timed per call (median of 20) and, beneath one event
    pair's floor, as 100 calls back to back (``_100``); the byte bound."""
    m, k = x.shape
    fused = lambda: AQ.act_quant_w4ax(x, k4)            # noqa: E731
    route = lambda: parent_route(torch, AQ, x, k4)      # noqa: E731
    return {"shape": f"M={m} K={k} k4={k4} bf16",
            "ms": time_ms(torch, fused), "ms_100": time_ms_100(torch, fused),
            "earlier_ms": time_ms(torch, route),
            "earlier_ms_100": time_ms_100(torch, route),
            "plain_ms": time_ms(torch,
                                lambda: AQ.act_quant_w4ax_ref(x, k4)),
            "bound_ms": act_bytes(m, k, k4) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def check_act_quant(torch, AQ, rows: dict):
    """The fused act-quant (K1 and K2 in one launch, bf16 read directly)
    byte for byte against its plain version at the Llama-3-8B widths and
    the other dense configurations' (``ARCH_ACT_SHAPES``) × ``ACT_M`` and
    on a strided-row view, one launch a call; at the Llama-3-8B widths K1
    and K2 alone (the kernel over one range) and the parent's route
    likewise.
    K1's and K2's rows both give the fused op's times at M = 256, K =
    4,096 (``down``: K = 14,336; ``decode``: M = 8) and, under
    ``alone``, their own over their range of that input."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def same(label, got, want):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.shape != w.shape:
                fail(f"{label}: shape {tuple(g.shape)}, plain version's "
                     f"{tuple(w.shape)}")
            if not torch.equal(g, w):
                fail(f"{label}: not byte-exact against its plain version "
                     f"({int((g != w).sum())} elements differ)")

    for k, k4 in ACT_SHAPES:
        for m in ACT_M:
            x = act_input(torch, gen, m, k, k4)
            same(f"act_quant_w4ax M={m} K={k} k4={k4}",
                 AQ.act_quant_w4ax(x, k4), AQ.act_quant_w4ax_ref(x, k4))
            same(f"act_quant_int4 M={m} K={k4}", AQ.act_quant_int4(x[:, :k4]),
                 AQ.act_quant_ref(x[:, :k4].float(), bits=4))
            same(f"act_quant_int8 M={m} K={k - k4}",
                 AQ.act_quant_int8(x[:, k4:]),
                 AQ.act_quant_ref(x[:, k4:].float(), bits=8))
            same(f"parent route M={m} K={k}", parent_route(torch, AQ, x, k4),
                 AQ.act_quant_w4ax_ref(x, k4))
            say(f"[kernels] act_quant_w4ax M={m} K={k} k4={k4}: byte-exact "
                f"(and K1, K2 alone, the parent's route)")
    for k, k4 in ARCH_ACT_SHAPES:
        for m in ACT_M:
            x = act_input(torch, gen, m, k, k4)
            same(f"act_quant_w4ax M={m} K={k} k4={k4}",
                 AQ.act_quant_w4ax(x, k4), AQ.act_quant_w4ax_ref(x, k4))
        say(f"[kernels] act_quant_w4ax M={ACT_M} K={k} k4={k4}: byte-exact")
    wide = act_input(torch, gen, 64, 4096 + 256, 3584)
    view = wide[:, 128:128 + 4096]          # row stride 4,352, offset 256 B
    same("act_quant_w4ax strided rows", AQ.act_quant_w4ax(view, 3584),
         AQ.act_quant_w4ax_ref(view, 3584))
    n = device_launches(torch, lambda: AQ.act_quant_w4ax(view, 3584))
    if n != 1:
        fail(f"act_quant_w4ax: {n:g} kernel launches a call")
    say(f"[kernels] act_quant_w4ax strided rows M=64 K=4096 (row stride "
        f"{view.stride(0)}): byte-exact; {n:g} launch a call")

    (k, k4), (kd, kd4) = ACT_SHAPES
    x = act_input(torch, gen, 256, k, k4)
    main = act_times(torch, AQ, x, k4)
    down = act_times(torch, AQ, act_input(torch, gen, 256, kd, kd4), kd4)
    dec = act_times(torch, AQ, act_input(torch, gen, 8, k, k4), k4)
    for name, kern, part, bits, line in (
            ("act_quant_int4", AQ.act_quant_int4, x[:, :k4], 4, 52),
            ("act_quant_int8", AQ.act_quant_int8, x[:, k4:], 8, 82)):
        mm, kk = part.shape
        out = mm * kk // 2 if bits == 4 else mm * kk
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/act_quant.cu",
            "replaces": f"src/repro/kernels/act_quant.py:{line}",
            "kernel": "act_quant_w4ax", "max_abs_err": 0.0, **main,
            "library_ms": None, "launches_per_call": n,
            "down": down, "decode": dec,
            "alone": {"shape": f"M={mm} K={kk} bf16 (row stride {k})",
                      "ms": time_ms(torch, lambda: kern(part)),
                      "ms_100": time_ms_100(torch, lambda: kern(part)),
                      "bound_ms": (mm * kk * 2 + out + mm * (kk // 128) * 4)
                      / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"},
        }
    say(f"[kernels] act_quant_w4ax times: {json.dumps(main)}")


GEMM_M = (1, 8, 16, 256)      # decode widths, the prefill tile's
GEMM_TIMED_M = (256, 8)       # the table row's shape, then its "decode"


def check_gemm(torch, AQ, WK, Q, rows: dict):
    """K3, K4 and K5 bit for bit against their plain versions at the four
    Llama-3-8B projection shapes × ``GEMM_M``; each timed at N = K = 4096
    for both M of ``GEMM_TIMED_M`` (the M = 8 times go under the row's
    ``decode`` key)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    # (N, K): q/o, k/v, up/gate, down projections of Llama-3-8B
    shapes = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))
    names = ("w4a4_matmul", "w4a8_matmul", "w4ax_matmul_mixed")
    timed = {}
    for n, k in shapes:
        nb = k // 128
        nb4 = int(round(0.875 * nb))
        k4 = nb4 * 128
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        wp, ws = Q.quantize_weight_int4(w, group_size=128)
        for m in GEMM_M:
            x = (torch.randn((m, k), generator=gen, device="cuda")
                 .bfloat16().float())
            a4, s4 = AQ.act_quant_ref(x[:, :k4].contiguous(), bits=4)
            a8, s8 = AQ.act_quant_ref(x[:, k4:].contiguous(), bits=8)
            w4p, w4s = wp[:k4 // 2], ws[:nb4]
            w8p, w8s = wp[k4 // 2:], ws[nb4:]
            for name, kern, ref, args in (
                    ("w4a4_matmul", WK.w4a4_matmul, WK.w4a4_matmul_ref,
                     (a4, s4, w4p, w4s)),
                    ("w4a8_matmul", WK.w4a8_matmul, WK.w4a8_matmul_ref,
                     (a8, s8, w8p, w8s)),
                    ("w4ax_matmul_mixed", WK.w4ax_matmul_mixed,
                     WK.w4ax_matmul_mixed_ref, (a4, s4, a8, s8, wp, ws))):
                out = kern(*args)
                want = ref(*args)
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                if not torch.equal(out, want):
                    fail(f"{name} M={m} N={n} K={k}: not bit-exact against "
                         f"its plain version (max err {err})")
                say(f"[kernels] {name} M={m} N={n} K={k}"
                    + (f" ({nb4}+{nb - nb4} blocks)"
                       if name == "w4ax_matmul_mixed" else "")
                    + ": exact")
                if m in GEMM_TIMED_M and (n, k) == (4096, 4096):
                    timed[name, m] = args
            # the composed split schedule against the mixed-precision oracle
            split = WK.w4ax_matmul_split(a4, s4, a8, s8, wp, ws)
            want = WK.w4ax_matmul_ref(a4, s4, a8, s8, w4p, w4s, w8p, w8s)
            err = float((split - want).abs().max())
            if not err <= 1e-5 * float(want.abs().max()):
                fail(f"w4ax_matmul_split M={m} N={n} K={k}: max err {err}")
    for name in names:
        main, dec = (gemm_times(torch, WK, Q, gen, name, timed[name, m])
                     for m in GEMM_TIMED_M)
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/w4ax_matmul.cu",
            "replaces": {"w4a4_matmul": "src/repro/kernels/w4ax_matmul.py:142",
                         "w4a8_matmul": "src/repro/kernels/w4ax_matmul.py:209",
                         "w4ax_matmul_mixed":
                         "src/repro/kernels/w4ax_matmul.py:288"}[name],
            "max_abs_err": 0.0, **main, "decode": dec}


def gemm_times(torch, WK, Q, gen, name: str, args) -> dict:
    """One GEMM kernel's times on these operands: the kernel, its plain
    version, a bf16 ``torch.matmul`` on the dequantized weights (the
    yardstick), the split pair (K3 + K4 + ``add_``) for the mixed kernel,
    and its bound: every operand read once and the output written once,
    or 2·M·N·K int8 operations."""
    kern = getattr(WK, name)
    ref = getattr(WK, name + "_ref")
    m, n = args[0].shape[0], args[-2].shape[1]
    kk = args[-2].shape[0] * 2
    nbytes = sum(t.numel() * t.element_size() for t in args) + m * n * 4
    ops_ = 2 * m * n * kk
    xb = torch.randn((m, kk), generator=gen, device="cuda").bfloat16()
    wb = Q.dequantize_weight_int4(args[-2], args[-1]).bfloat16()
    shape = f"M={m} N={n} K={kk}"
    if name == "w4ax_matmul_mixed":
        shape += f" ({args[1].shape[1]}+{args[3].shape[1]} blocks)"
    row = {
        "shape": shape,
        "ms": time_ms(torch, lambda: kern(*args)),
        "plain_ms": time_ms(torch, lambda: ref(*args)),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                        ops_ / INT8_OPS_PER_S) * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= ops_ / INT8_OPS_PER_S else "operations"),
        "library_ms": time_ms(torch, lambda: torch.matmul(xb, wb)),
    }
    if name == "w4ax_matmul_mixed":
        row["split_ms"] = time_ms(torch, lambda: WK.w4ax_matmul_split(*args))
    return row


PREFILL_ROWS = ((300, 1), (129, 1), (64, 1), (128, 256), (200, 100),
                (0, 256))        # (history, chunk): decode, mid-prefill, first
DECODE_LENS = (487, 405, 356, 263, 278, 175, 188, 166)   # not page multiples


def llama_cache(torch, cfg, KVC, rows, seed: int):
    """A real cache state at Llama-3-8B widths: random int4 pools and one
    sequence per (history, chunk) row, allocated for history + chunk and
    holding the history."""
    cache = KVC.PagedKV4Cache(
        cfg, KVC.PagedKV4Config(num_pages=512, page_size=64, max_seqs=16,
                                max_pages_per_seq=64),
        num_layer_slots=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for pool in (cache.k_pool, cache.v_pool):
        pool.copy_(torch.randint(0, 256, pool.shape, generator=gen,
                                 device="cuda", dtype=torch.int32)
                   .to(torch.uint8))
    for slot, (ctx, take) in enumerate(rows):
        assert cache.allocate_seq(slot, ctx + take)
        cache.seq_len[slot] = ctx
    return cache, gen


def attention_case(torch, cfg, KVC):
    """The prefill attention inputs of a real cache state: decode rows,
    mid-prefill rows, a zero-history row, and two qlen-0 pad rows of the
    power-of-two row bucket; both the work-queue descriptors and the
    dense schedule's bucketed tables (pad rows: page 0, no history)."""
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    cache, gen = llama_cache(torch, cfg, KVC, PREFILL_ROWS, 3)
    starts = [c for c, _ in PREFILL_ROWS]
    takes = [t for _, t in PREFILL_ROWS]
    slots = list(range(len(PREFILL_ROWS)))
    nb, cb = 8, 256
    desc = cache.work_queue_np(slots, starts, takes, pad_row=nb * hkv)
    q = torch.randn((nb, cb, cfg.num_heads, d), generator=gen,
                    device="cuda").bfloat16()
    kn = torch.randn((nb, cb, hkv, d), generator=gen, device="cuda") * 4
    vn = torch.randn((nb, cb, hkv, d), generator=gen, device="cuda") * 4
    pools = (cache.k_pool[0], cache.k_scale, cache.k_zero,
             cache.v_pool[0], cache.v_scale, cache.v_zero)
    args = (q, kn, vn) + pools + (torch.from_numpy(desc).cuda(),)
    npb = 1 << (cache.pages_needed(max(starts)) - 1).bit_length()
    tables = np.zeros((nb, npb), np.int32)
    tables[:len(slots)] = cache.block_tables_np(slots, npb)

    def pad(a):
        return torch.tensor(list(a) + [0] * (nb - len(a)), dtype=torch.int32,
                            device="cuda")

    dense = (q, kn, vn) + pools + (torch.from_numpy(tables).cuda(),
                                   pad(starts), pad(takes))
    return args, desc, takes, dense, cache


def repeat_heads(x, g: int):
    """[B, Hkv, T, D] → [B, Hkv·G, T, D]: the GQA heads written out."""
    return x.repeat_interleave(g, dim=1)


def sdpa_prefill_inputs(torch, Q, cache, dense, hq: int):
    """The library yardstick's inputs for chunked prefill attention: bf16
    q ``[B, Hq, C, D]``, K/V = the rows' history pages dequantized and
    the chunk, heads repeated, and the same mask (history t < ctx, chunk
    j ≤ i and j < q_len)."""
    q, kn, vn, _, ks, kz, _, vs, vz, tables, ctx, ql = dense
    b, c, _, d = q.shape
    hkv = kn.shape[2]
    t_hist = tables.shape[1] * cache.pcfg.page_size
    idx = tables.long()
    kv = []
    for pool, s, z, new in ((cache.k_pool[0], ks, kz, kn),
                            (cache.v_pool[0], vs, vz, vn)):
        hist = pool[idx].reshape(b, t_hist, hkv, d // 2).transpose(1, 2)
        hist = Q.dequantize_kv_channelwise(hist, s, z)
        kv.append(repeat_heads(torch.cat([hist, new.transpose(1, 2)], 2)
                               .bfloat16(), hq // hkv).contiguous())
    tpos = torch.arange(t_hist + c, device="cuda")
    j = tpos - t_hist
    i = torch.arange(c, device="cuda")
    mask = torch.where((tpos < t_hist)[None, None, :],
                       (tpos[None, :] < ctx[:, None].long())[:, None, :],
                       (j[None, None, :] <= i[None, :, None])
                       & (j[None, None, :] < ql[:, None, None].long()))
    return (q.transpose(1, 2).contiguous(), kv[0], kv[1], mask[:, None])


def check(name: str, got, want, tol_rows=None) -> float:
    """Max error of a kernel against its plain version (over the valid
    rows ``tol_rows`` (b, q_len) pairs where given), within
    1e-4·max(1, max|ref|), every output finite."""
    import torch
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    pairs = [(got, want)] if tol_rows is None else [
        (got[b, :n], want[b, :n]) for b, n in tol_rows if n]
    err = max(float((g - w).abs().max()) for g, w in pairs)
    tol = 1e-4 * max(1.0, max(float(w.abs().max()) for _, w in pairs))
    if not err <= tol:
        fail(f"{name}: max err {err} > {tol}")
    return err


def check_exact(name: str, got, want, tol_rows) -> float:
    """``check``, and bit for bit on the valid rows: the kernels that
    compute exactly as their plain versions do must agree exactly."""
    err = check(name, got, want, tol_rows)
    if err != 0.0:
        fail(f"{name}: max err {err} against its plain version; it must be "
             f"bit-exact")
    return err


def bound(nbytes: float, flops: float) -> dict:
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = flops / F32_FLOPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def prefill_bound(ctx, qls, hkv: int, g: int, d: int, q_bytes: int = 2):
    """Bytes and f32 operations of chunked prefill attention for these
    rows, whichever schedule computes it (K7 dense, K9 work queue): each
    valid query (i < q_len) against its valid keys (the history [0, ctx)
    and chunk keys j ≤ i), 4·D operations per pair (q·k and p·v); each
    row's valid queries (``q_bytes`` each), chunk k/v (f32) and int4
    history pages read once, its valid f32 outputs written once."""
    flops = nbytes = 0
    for cx, ql in zip(ctx, qls):
        if not ql:
            continue
        pairs = ql * cx + ql * (ql + 1) // 2
        flops += pairs * g * hkv * 4 * d
        nbytes += (ql * g * hkv * d * (q_bytes + 4)  # q in, out
                   + ql * hkv * d * 4 * 2            # chunk k, v
                   + cx * hkv * (d // 2) * 2)        # int4 history k, v
    return nbytes, flops


def decode_bound(lengths, hq: int, hkv: int, d: int, extra_bytes: int = 0):
    """Bytes and f32 operations of decode attention over these lengths:
    the int4 K and V of every valid key of every kv head read once, each
    bf16 query read and each f32 output written once, plus
    ``extra_bytes`` (the op's own inputs: scales, tables, descriptors);
    4·D operations per (query head, key)."""
    keys = int(sum(lengths))
    nbytes = (keys * hkv * (d // 2) * 2 + len(lengths) * hq * d * (2 + 4)
              + extra_bytes)
    return nbytes, keys * hq * 4 * d


META = {  # each attention kernel's source and the TPU kernel it replaces
    "paged_kv4_prefill_attention_wq": ("paged_attention.cu",
                                       "paged_attention.py:622"),
    "paged_kv4_prefill_attention": ("paged_attention.cu",
                                    "paged_attention.py:336"),
    "kv4_decode_attention": ("kv4_attention.cu", "kv4_attention.py:111"),
    "paged_kv4_decode_attention": ("paged_decode.cu",
                                   "paged_attention.py:163"),
    "paged_kv4_decode_attention_wq": ("paged_attention.cu",
                                      "paged_attention.py:477"),
}


def put(rows: dict, name: str, key, entry: dict):
    """A kernel-table entry: the kernel's row itself (``key`` None), else
    under ``key`` of its row."""
    if key is not None:
        rows[name][key] = entry
        return
    src, at = META[name]
    rows[name] = {"name": name, "route": "cuda",
                  "source": f"src/repro_torch/csrc/{src}",
                  "replaces": f"src/repro/kernels/{at}", **entry}


# (kv heads, G) held beside Llama-3-8B's 32/8 heads (Mistral-NeMo-12B's
# too): Qwen2.5-32B's 40/8, Llama-3-70B's and Qwen2-72B's 64/8,
# StarCoder2-15B's 48/4 (16-row tiles at C = 1), Qwen3-MoE's 64/4
GQA = ((8, 5), (8, 8), (4, 12), (4, 16))


def gqa_cfg(cfg, hkv: int, g: int):
    return dataclasses.replace(cfg, num_heads=hkv * g, num_kv_heads=hkv)


def check_attention(torch, cfg, KVC, PA, Q, rows: dict, key=None):
    """K9 (work-queue prefill) and K7 (dense prefill) on one real cache
    state at ``cfg``'s heads, bit for bit against their plain versions,
    with one library yardstick; the kernels' rows, or entries under
    ``key``."""
    import torch.nn.functional as F
    args, desc, takes, dense, cache = attention_case(torch, cfg, KVC)
    b, c, hq, d = args[0].shape
    hkv = cfg.num_kv_heads
    g = hq // hkv
    valid = list(enumerate(takes))
    yard = sdpa_prefill_inputs(torch, Q, cache, dense, hq)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        yard[0], yard[1], yard[2], attn_mask=yard[3]))
    del yard
    shape = f"B={b} C={c} Hq={hq} Hkv={hkv} G={g} D={d}"
    ctx = [cx for cx, _ in PREFILL_ROWS]

    # the whole op (pre-fold, partials, combine) in one launch, with the
    # engine's host plan, against its plain version
    plan = PA.work_plan(desc, b * hkv, c, g, "cuda")
    op = lambda: PA.paged_kv4_prefill_attention_wq(*args, plan=plan)  # noqa: E731
    ref = lambda: PA.paged_kv4_prefill_attention_wq_ref(*args, plan=plan)  # noqa: E731
    tag = f" {key}" if key else ""
    label = "paged_kv4_prefill_attention_wq" + tag
    err = check_exact(label, op(), ref(), valid)
    n = device_launches(torch, op)
    if not 1 <= n <= 2:
        fail(f"{label}: {n:g} kernel launches a call")
    say(f"[kernels] paged_kv4_prefill_attention_wq {shape} W={desc.shape[0]}"
        f": max err {err:.3g}; {n:g} launch(es) a call, "
        f"{plan.jobs.shape[0]} blocks of {plan.rows} rows")
    put(rows, "paged_kv4_prefill_attention_wq", key, {
        "shape": f"{shape} W={desc.shape[0]}", "max_abs_err": err,
        "rows": plan.rows, "ms": time_ms(torch, op),
        "plain_ms": time_ms(torch, ref),
        **bound(*prefill_bound(ctx, takes, hkv, g, d)),
        "library_ms": library_ms, "launches_per_call": n})

    op = lambda: PA.paged_kv4_prefill_attention(*dense)  # noqa: E731
    ref = lambda: PA.paged_kv4_prefill_attention_ref(*dense)  # noqa: E731
    err = check_exact("paged_kv4_prefill_attention" + tag, op(), ref(),
                      valid)
    say(f"[kernels] paged_kv4_prefill_attention {shape} "
        f"NP={dense[9].shape[1]}: max err {err:.3g}")
    put(rows, "paged_kv4_prefill_attention", key, {
        "shape": f"{shape} NP={dense[9].shape[1]}", "max_abs_err": err,
        "ms": time_ms(torch, op), "plain_ms": time_ms(torch, ref),
        **bound(*prefill_bound(ctx, takes, hkv, g, d)),
        "library_ms": library_ms})


SPEC_C, SPEC_CB = 5, 8     # a k = 4 verify chunk, padded to its bucket


def check_spec_attention(torch, cfg, KVC, PA, Q, rows: dict):
    """K9 at the verify shape of speculative decode: the decode batch's
    rows (histories ``DECODE_LENS``), each a chunk of ``SPEC_C`` valid
    queries (the last sampled token and 4 drafts) padded to ``SPEC_CB``,
    the chunk's int4 KV already in its pages and its in-flight keys
    fake-quantized, as the engine feeds them on the card: under the
    verify layout (``build_work_queue(verify=...)``, the path's) and the
    parent's (in-flight reads of the chunk's earlier keys), each bit for
    bit against its plain version, one or two launches a call, with SDPA
    on the same keys; then the verify layout's query i must equal, bit for
    bit, K9 over the decode step of the same token at ctx + i (a chunk of
    1, every row). An entry under K9's row, ``C=5 spec``; ``earlier_ms``
    times the parent's layout."""
    import torch.nn.functional as F
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = hq // hkv
    cache, gen = llama_cache(torch, cfg, KVC,
                             [(n, SPEC_C) for n in DECODE_LENS], 5)
    slots = list(range(len(DECODE_LENS)))
    b = len(slots)
    takes = [SPEC_C] * b
    ctx = np.asarray(DECODE_LENS)
    q = torch.zeros((b, SPEC_CB, hq, d), device="cuda", dtype=torch.bfloat16)
    q[:, :SPEC_C] = torch.randn((b, SPEC_C, hq, d), generator=gen,
                                device="cuda").bfloat16()
    # the chunk's KV: written to its pages, and fake-quantized in flight
    k, v = (torch.randn((1, b * SPEC_C, hkv, d), generator=gen,
                        device="cuda") * 4 for _ in range(2))
    pos = (ctx[:, None] + np.arange(SPEC_C)).ravel()
    pages, offs = cache.token_dests(np.repeat(slots, SPEC_C), pos)
    cache.scatter_tokens(0, pages, offs, k, v)
    kdq, vdq = KVC.qdq_kv_with(k, v, cache.k_scale, cache.k_zero,
                               cache.v_scale, cache.v_zero)
    kn, vn = (torch.zeros((b, SPEC_CB, hkv, d), device="cuda")
              for _ in range(2))
    kn[:, :SPEC_C] = kdq[0].reshape(b, SPEC_C, hkv, d)
    vn[:, :SPEC_C] = vdq[0].reshape(b, SPEC_C, hkv, d)
    pools = (cache.k_pool[0], cache.k_scale, cache.k_zero,
             cache.v_pool[0], cache.v_scale, cache.v_zero)
    npb = 1 << (cache.pages_needed(max(DECODE_LENS)) - 1).bit_length()
    tables = torch.from_numpy(cache.block_tables_np(slots, npb)).cuda()
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    qls = torch.full((b,), SPEC_C, dtype=torch.int32, device="cuda")
    yard = sdpa_prefill_inputs(torch, Q, cache,
                               (q, kn, vn) + pools + (tables, lens, qls), hq)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        yard[0], yard[1], yard[2], attn_mask=yard[3]))
    del yard
    label = "paged_kv4_prefill_attention_wq C=5 spec"
    valid = [(i, SPEC_C) for i in range(b)]
    timed = {}
    for layout, verify in (("verify", [True] * b), ("parent", None)):
        desc = cache.work_queue_np(slots, DECODE_LENS, takes,
                                   pad_row=b * hkv, verify=verify)
        args = (q, kn, vn) + pools + (torch.from_numpy(desc).cuda(),)
        plan = PA.work_plan(desc, b * hkv, SPEC_CB, g, "cuda")
        op = lambda a=args, p=plan: PA.paged_kv4_prefill_attention_wq(  # noqa: E731
            *a, plan=p)
        ref = lambda a=args, p=plan: PA.paged_kv4_prefill_attention_wq_ref(  # noqa: E731
            *a, plan=p)
        got = op()
        err = check_exact(f"{label} ({layout} layout)", got, ref(), valid)
        n = device_launches(torch, op)
        if not 1 <= n <= 2:
            fail(f"{label} ({layout} layout): {n:g} kernel launches a call")
        timed[layout] = dict(out=got, err=err, n=n, desc=desc, plan=plan,
                             ms=time_ms(torch, op), plain_ms=time_ms(
                                 torch, ref))
    # query i of the verify chunk against the decode step at ctx + i
    out = timed["verify"]["out"]
    for i in range(SPEC_C):
        desc = cache.work_queue_np(slots, ctx + i, [1] * b, pad_row=b * hkv)
        one = PA.paged_kv4_prefill_attention_wq(
            q[:, i:i + 1].contiguous(), kn[:, i:i + 1].contiguous(),
            vn[:, i:i + 1].contiguous(), *pools,
            torch.from_numpy(desc).cuda(),
            plan=PA.work_plan(desc, b * hkv, 1, g, "cuda"))
        if not torch.equal(out[:, i], one[:, 0]):
            fail(f"{label}: verify position {i} is not the decode step at "
                 f"ctx + {i} (max diff "
                 f"{float((out[:, i] - one[:, 0]).abs().max()):.3g})")
    new = timed["verify"]
    shape = (f"B={b} C={SPEC_C} (of {SPEC_CB}) Hq={hq} Hkv={hkv} G={g} D={d} "
             f"T={max(DECODE_LENS)} W={new['desc'].shape[0]}, verify layout")
    say(f"[kernels] paged_kv4_prefill_attention_wq {shape}: max err "
        f"{new['err']:.3g}; {new['n']:g} launch(es) a call, "
        f"{new['plan'].jobs.shape[0]} blocks of {new['plan'].rows} rows; "
        f"every position equals its decode step; {new['ms']:.6f} ms "
        f"(parent's layout, W={timed['parent']['desc'].shape[0]}: "
        f"{timed['parent']['ms']:.6f} ms, max err "
        f"{timed['parent']['err']:.3g})")
    put(rows, "paged_kv4_prefill_attention_wq", "C=5 spec", {
        "shape": shape, "max_abs_err": new["err"], "rows": new["plan"].rows,
        "ms": new["ms"], "earlier_ms": timed["parent"]["ms"],
        "plain_ms": new["plain_ms"],
        **bound(*prefill_bound(DECODE_LENS, takes, hkv, g, d)),
        "library_ms": library_ms, "launches_per_call": new["n"]})


def device_launches(torch, fn, calls: int = 3, tries: int = 5) -> float:
    """Kernels one call of ``fn`` puts on the card, by ``torch.profiler``
    (after a warm-up call): ``calls`` calls traced between marker kernels
    (``torch.cuda._sleep``), two before and one after, and counted on the
    trace's timeline between the last leading marker and the trailing
    one. A profiling session of a process can miss the first kernel it
    should see (on the H100: the first leading marker, consistently, once
    the process has run the kernels phase's GEMMs) or come back without
    the card's activity; a trace whose op kernels are not bracketed by
    markers is taken again, at most ``tries`` times, and never counted."""
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
        say(f"[kernels] a torch.profiler trace lost the card's activity "
            f"(saw {len(marks)} kernels, {sum(marks)} markers); taken again")
    fail(f"torch.profiler lost the card's activity in {tries} traces")


def check_decode(torch, cfg, KVC, PA, KA, Q, rows: dict, key=None):
    """K6, K8 and K10, and K7 and K9 at C = 1, on one decode batch of a
    real cache state (8 rows, lengths that are not page multiples) at
    ``cfg``'s heads, bit for bit against their plain versions, with one
    SDPA yardstick on the gathered, dequantized bf16 KV; the decode
    kernels' rows (K7's and K9's under ``decode``), or entries under
    ``key`` (K7's and K9's under ``<key> C=1``)."""
    import torch.nn.functional as F
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = hq // hkv
    cache, gen = llama_cache(torch, cfg, KVC, [(n, 1) for n in DECODE_LENS],
                             4)
    slots = list(range(len(DECODE_LENS)))
    b = len(slots)
    lens_np = np.asarray(DECODE_LENS)
    max_len = int(lens_np.max())
    lengths = torch.from_numpy(lens_np.astype(np.int32)).cuda()
    q = torch.randn((b, hq, d), generator=gen, device="cuda").bfloat16()
    pools = (cache.k_pool[0], cache.k_scale, cache.k_zero, cache.v_pool[0],
             cache.v_scale, cache.v_zero)
    kp, vp, _ = cache.gather_kv(0, slots, max_len)
    kp, vp = kp.contiguous(), vp.contiguous()
    bc = [torch.broadcast_to(s[None], (b,) + tuple(s.shape))
          for s in pools[1:3] + pools[4:6]]
    tables = cache.block_tables_device(slots, max_len)
    k10 = (q, kp, bc[0], bc[1], vp, bc[2], bc[3], lengths)
    k6 = (q,) + pools + (tables, lengths)
    desc = cache.work_queue_np(slots, lens_np)
    plan = PA.work_plan(desc, b * hkv, 1, g, "cuda")
    k8 = (q,) + pools + (torch.from_numpy(desc).cuda(),)
    # K7 and K9 at decode shape: the same rows as one new token each over
    # their history (the unified step's decode rows), C = 1; K9 with one
    # page item per history page and a one-key chunk item per (row, head)
    kn1, vn1 = (torch.randn((b, 1, hkv, d), generator=gen, device="cuda") * 4
                for _ in range(2))
    k7 = ((q[:, None], kn1, vn1) + pools
          + (tables, lengths, torch.ones(b, dtype=torch.int32,
                                         device="cuda")))
    desc9 = cache.work_queue_np(slots, lens_np, [1] * b)
    k9 = ((q[:, None], kn1, vn1) + pools + (torch.from_numpy(desc9).cuda(),))
    plan9 = PA.work_plan(desc9, b * hkv, 1, g, "cuda")

    mask = (torch.arange(max_len, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    yk, yv = [repeat_heads(Q.dequantize_kv_channelwise(x, s, z).bfloat16(), g)
              .contiguous() for x, s, z in ((kp, bc[0], bc[1]),
                                            (vp, bc[2], bc[3]))]
    yq = q[:, :, None, :].contiguous()
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        yq, yk, yv, attn_mask=mask))
    del yk, yv
    # each decode op's inputs besides q and the KV: the four scale tensors
    # the batch shares, the lengths (K10, K6), K6's block table, K8's
    # descriptors and jobs
    scales = sum(pools[i].nbytes for i in (1, 2, 4, 5))
    shape = f"B={b} Hq={hq} Hkv={hkv} G={g} D={d} T={max_len}"
    heads = [(i, hq) for i in range(b)]
    ones = [(i, 1) for i in range(b)]
    c1 = "decode" if key is None else f"{key} C=1"
    cases = (   # name, kernel, plain version, valid rows, key, shape, bound
        ("kv4_decode_attention", lambda: KA.kv4_decode_attention(*k10),
         lambda: KA.kv4_decode_attention_ref(*k10), heads, key, shape,
         decode_bound(DECODE_LENS, hq, hkv, d, scales + lengths.nbytes),
         KA.dense_plan(b, 1, g, hkv, 1, max_len, d).rows),
        ("paged_kv4_decode_attention",
         lambda: PA.paged_kv4_decode_attention(*k6),
         lambda: PA.paged_kv4_decode_attention_ref(*k6), heads, key, shape,
         decode_bound(DECODE_LENS, hq, hkv, d,
                      scales + lengths.nbytes + tables.nbytes),
         KA.dense_plan(b, 1, g, hkv, tables.shape[1],
                       cache.pcfg.page_size, d).rows),
        ("paged_kv4_prefill_attention",
         lambda: PA.paged_kv4_prefill_attention(*k7),
         lambda: PA.paged_kv4_prefill_attention_ref(*k7), ones, c1,
         f"{shape} C=1", prefill_bound(DECODE_LENS, [1] * b, hkv, g, d),
         KA.dense_plan(b, 1, g, hkv, tables.shape[1],
                       cache.pcfg.page_size, d).rows),
        ("paged_kv4_prefill_attention_wq",
         lambda: PA.paged_kv4_prefill_attention_wq(*k9, plan=plan9),
         lambda: PA.paged_kv4_prefill_attention_wq_ref(*k9, plan=plan9),
         ones, c1, f"{shape} C=1 W={desc9.shape[0]}",
         prefill_bound(DECODE_LENS, [1] * b, hkv, g, d), plan9.rows),
        # the whole op (pre-fold, partials, combine, V affine) in one
        # launch, with the engine's host plan
        ("paged_kv4_decode_attention_wq",
         lambda: PA.paged_kv4_decode_attention_wq(*k8, plan=plan),
         lambda: PA.paged_kv4_decode_attention_wq_ref(*k8, plan=plan),
         heads, key, f"{shape} W={desc.shape[0]}",
         decode_bound(DECODE_LENS, hq, hkv, d,
                      scales + desc.nbytes + plan.jobs.nbytes), plan.rows))
    for name, op, ref, valid, at, shp, bnd, nrows in cases:
        label = name + (f" {at}" if at else "")
        err = check_exact(label, op(), ref(), valid)
        entry = {"shape": shp, "max_abs_err": err, "rows": nrows,
                 "ms": time_ms(torch, op), "plain_ms": time_ms(torch, ref),
                 **bound(*bnd), "library_ms": library_ms}
        extra = ""
        if name == "paged_kv4_decode_attention_wq":
            n = device_launches(torch, op)
            if n != 1:
                fail(f"{label}: {n:g} kernel launches a call")
            entry["launches_per_call"] = n
            extra = f"; {n:g} launch a call"
        say(f"[kernels] {name} {shp}: max err {err:.3g}; tiles of {nrows} "
            f"rows{extra}")
        put(rows, name, at, entry)


# the head_dims K6–K10 are built for besides 128 (the smoke configs' 32,
# the TP test model's 64, Zamba2's 80), each held at these GQA groups on
# Llama-3-8B's 8 kv heads (G = 4 is the 8B's own 32/8, timed)
HEAD_DIM_CASES = (32, 64, 80)
HEAD_DIM_GROUPS = (4, 1, 2, 8)


def check_head_dims(torch, cfg8b, KVC, PA, KA, Q, rows: dict):
    """K6–K10 at each of ``HEAD_DIM_CASES`` and each GQA group of
    ``HEAD_DIM_GROUPS``, on the kernels phase's cache states (decode batch
    B = 8, T = 487; prefill C = 256 and C = 1), bit for bit against their
    plain versions: entries ``D=<d> Hq=32`` (K7's and K9's ``… C=1``)
    and ``D=<d> Hq=32 C=256`` at G = 4 (the 8B's heads, the table's timed
    rows), and ``D=<d> G=<g>`` (``… C=1``, ``… C=256``) at the others. A
    width not built (96) must raise."""
    for d in HEAD_DIM_CASES:
        for g in HEAD_DIM_GROUPS:
            cfg = dataclasses.replace(gqa_cfg(cfg8b, cfg8b.num_kv_heads, g),
                                      head_dim=d)
            key = f"D={d} " + ("Hq=32" if g == 4 else f"G={g}")
            check_decode(torch, cfg, KVC, PA, KA, Q, rows, key)
            check_attention(torch, cfg, KVC, PA, Q, rows, f"{key} C=256")
    q = torch.zeros((1, 8, 96), device="cuda")
    kv = torch.zeros((1, 8, 64, 48), dtype=torch.uint8, device="cuda")
    s = torch.ones((8, 1, 96), device="cuda")
    try:
        KA.kv4_decode_attention(q, kv, s, s, kv, s, s,
                                torch.ones(1, dtype=torch.int32,
                                           device="cuda"))
    except ValueError as e:
        say(f"[kernels] head_dim 96 refused: {e}")
    else:
        fail("kv4_decode_attention took head_dim 96, a width not built")


# (N, K) of the new configurations' widest projections: Llama-3-70B's
# up/gate and down, Qwen2-72B's down (231 blocks: 202 int4 and an odd 29
# int8 at int4_fraction 0.875)
ARCH_GEMMS = ((28672, 8192), (8192, 28672), (8192, 29568))


def check_gemm_archs(torch, AQ, WK, Q, rows: dict):
    """K3 and K4 bit for bit against their plain versions at
    ``ARCH_GEMMS`` × M ∈ {8, 256}, each timed beside its plain version,
    its bound and a bf16 ``torch.matmul``; rows under ``archs``."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    for n, k in ARCH_GEMMS:
        nb = k // 128
        nb4 = int(round(0.875 * nb))
        k4 = nb4 * 128
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        wp, ws = Q.quantize_weight_int4(w, group_size=128)
        del w
        for m in GEMM_TIMED_M:
            x = (torch.randn((m, k), generator=gen, device="cuda")
                 .bfloat16().float())
            a4, s4 = AQ.act_quant_ref(x[:, :k4].contiguous(), bits=4)
            a8, s8 = AQ.act_quant_ref(x[:, k4:].contiguous(), bits=8)
            for name, kern, ref, args in (
                    ("w4a4_matmul", WK.w4a4_matmul, WK.w4a4_matmul_ref,
                     (a4, s4, wp[:k4 // 2], ws[:nb4])),
                    ("w4a8_matmul", WK.w4a8_matmul, WK.w4a8_matmul_ref,
                     (a8, s8, wp[k4 // 2:], ws[nb4:]))):
                out, want = kern(*args), ref(*args)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    fail(f"{name} M={m} N={n} K={k}: not bit-exact against "
                         f"its plain version (max err "
                         f"{float((out - want).abs().max())})")
                row = gemm_times(torch, WK, Q, gen, name, args)
                say(f"[kernels] {name} {row['shape']} (of N={n} K={k}): "
                    f"exact; {row['ms']:.4f} ms, bound "
                    f"{row['bound_ms']:.4f}, bf16 matmul "
                    f"{row['library_ms']:.4f}")
                rows[name].setdefault("archs", []).append(
                    dict(row, max_abs_err=0.0))
        del wp, ws


def act_route_times(torch, ops) -> dict:
    """Unchecked times of one projection input's act-quant on bf16 at
    M = 256 (K = 4,096 and 14,336) and M = 8 (K = 4,096), per call and
    as 100 calls back to back: ``ops.act_quant`` once per channel range
    (the route every tree of the port has; before the fused op it made an
    f32 copy of each range) and, where the tree has it, the fused op."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    times = {}
    for m, (k, k4) in ((256, ACT_SHAPES[0]), (256, ACT_SHAPES[1]),
                       (8, ACT_SHAPES[0])):
        x = act_input(torch, gen, m, k, k4)
        fns = {"ops.act_quant per range": lambda: (
            ops.act_quant(x[:, :k4], bits=4),
            ops.act_quant(x[:, k4:], bits=8))}
        if hasattr(ops, "act_quant_w4ax"):
            fns["act_quant_w4ax"] = lambda: ops.act_quant_w4ax(x, k4)
        for name, fn in fns.items():
            times[f"{name} M={m} K={k}"] = time_ms(torch, fn)
            times[f"{name} M={m} K={k} x100"] = time_ms_100(torch, fn)
    return times


def gemm_route_times(torch) -> dict:
    """Unchecked times (median of 50) of the dense K3, K4 and K5 at the
    Llama-3-8B q/o, up/gate and down shapes, M = 256 and 8, through the
    single-expert entry points every tree of the port has."""
    from repro_torch.core import quantizer as Q
    from repro_torch.kernels import act_quant as AQ
    from repro_torch.kernels import w4ax_matmul as WK
    gen = torch.Generator(device="cuda").manual_seed(2)
    times = {}
    for n, k in ((4096, 4096), (14336, 4096), (4096, 14336)):
        nb4 = int(round(0.875 * (k // 128)))
        k4 = nb4 * 128
        wp, ws = Q.quantize_weight_int4(
            torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5)
        for m in (256, 8):
            x = torch.randn((m, k), generator=gen,
                            device="cuda").bfloat16().float()
            a4, s4 = AQ.act_quant_ref(x[:, :k4].contiguous(), bits=4)
            a8, s8 = AQ.act_quant_ref(x[:, k4:].contiguous(), bits=8)
            for name, fn in (
                    ("K3", lambda: WK.w4a4_matmul(a4, s4, wp[:k4 // 2],
                                                  ws[:nb4])),
                    ("K4", lambda: WK.w4a8_matmul(a8, s8, wp[k4 // 2:],
                                                  ws[nb4:])),
                    ("K5", lambda: WK.w4ax_matmul_mixed(a4, s4, a8, s8, wp,
                                                        ws))):
                times[f"{name} M={m} N={n} K={k}"] = time_ms(torch, fn,
                                                             iters=50)
    return times


def phase_times(torch, cfg, KVC, PA, KA, ops):
    """Unchecked times of the ops this package's paths run, on the
    kernels phase's inputs (so two trees can be timed in turns in one
    call, when both have these ops' signatures): the act-quant of one
    projection input (:func:`act_route_times`), the dense W4Ax GEMMs
    (:func:`gemm_route_times`), K9's whole op at B = 8, C = 256 and at
    C = 1 on the decode rows, K6, K8's whole op and K10 on those rows."""
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = hq // hkv
    args, desc, _, _, _ = attention_case(torch, cfg, KVC)
    b, c = args[0].shape[:2]
    plan = PA.work_plan(desc, b * hkv, c, g, "cuda")
    cache, gen = llama_cache(torch, cfg, KVC, [(n, 1) for n in DECODE_LENS],
                             4)
    slots = list(range(len(DECODE_LENS)))
    b1 = len(slots)
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    q = torch.randn((b1, hq, d), generator=gen, device="cuda").bfloat16()
    pools = (cache.k_pool[0], cache.k_scale, cache.k_zero, cache.v_pool[0],
             cache.v_scale, cache.v_zero)
    kn1, vn1 = (torch.randn((b1, 1, hkv, d), generator=gen, device="cuda")
                for _ in range(2))
    desc9 = cache.work_queue_np(slots, np.asarray(DECODE_LENS), [1] * b1)
    k9 = (q[:, None], kn1, vn1) + pools + (torch.from_numpy(desc9).cuda(),)
    plan9 = PA.work_plan(desc9, b1 * hkv, 1, g, "cuda")
    k6 = (q,) + pools + (cache.block_tables_device(slots, max(DECODE_LENS)),
                         lens)
    desc8 = cache.work_queue_np(slots, np.asarray(DECODE_LENS))
    k8 = (q,) + pools + (torch.from_numpy(desc8).cuda(),)
    plan8 = PA.work_plan(desc8, b1 * hkv, 1, g, "cuda")
    kp, vp, _ = cache.gather_kv(0, slots, max(DECODE_LENS))
    k10 = (q, kp.contiguous(), *[
        torch.broadcast_to(s[None], (b1,) + tuple(s.shape))
        for s in pools[1:3]], vp.contiguous(), *[
        torch.broadcast_to(s[None], (b1,) + tuple(s.shape))
        for s in pools[4:6]], lens)
    times = {
        **act_route_times(torch, ops),
        **gemm_route_times(torch),
        "paged_kv4_prefill_attention_wq C=256": time_ms(
            torch, lambda: PA.paged_kv4_prefill_attention_wq(*args,
                                                             plan=plan)),
        "paged_kv4_prefill_attention_wq C=1": time_ms(
            torch, lambda: PA.paged_kv4_prefill_attention_wq(*k9,
                                                             plan=plan9)),
        "paged_kv4_decode_attention": time_ms(
            torch, lambda: PA.paged_kv4_decode_attention(*k6)),
        "paged_kv4_decode_attention_wq": time_ms(
            torch, lambda: PA.paged_kv4_decode_attention_wq(*k8,
                                                            plan=plan8)),
        "kv4_decode_attention": time_ms(
            torch, lambda: KA.kv4_decode_attention(*k10)),
    }
    say(f"[times] {HERE} {json.dumps(times)}")


# ------------------------------------------------------- phases 3 and 4

def serve(torch, np, Engine, EngineConfig, QuantConfig, cfg, params, impl,
          prompts, max_new, ecfg, quant_kw, sampling=None, faults=None,
          mesh=None, param_axes=None, profile_steps=None,
          count_drops=False):
    """Serve ``prompts`` to completion under ``QuantConfig(impl=impl,
    **quant_kw)``, each request greedy or with ``SamplingParams`` fields
    ``sampling`` (temperature, top_k, speculation); ``faults``: a fault
    injector to arm; ``mesh``/``param_axes``: a tensor-parallel rank's
    engine; ``profile_steps`` ``(first, last)``: count the kernel launch
    calls of those steps (``torch.profiler``), left on the engine as
    ``smoke_launch_calls``, and stop after them; → (engine, the first
    logits the engine
    produced, host seconds per step). The unified step's logits come from
    ``_guarded_forward``, the split forwards' from the rows they hand to
    ``_sample_batch``. A ``SanitizerError`` (``ecfg.sanitize``) fails the
    script."""
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.sanitize import SanitizerError
    eng = Engine(cfg, params, QuantConfig(impl=impl, **quant_kw), ecfg,
                 device=mesh.device if mesh is not None else "cuda",
                 mesh=mesh, param_axes=param_axes,
                 **({} if faults is None else {"faults": faults}))
    if count_drops:
        eng.moe_dropped = []
    first = []
    for name in ("_guarded_forward", "_sample_batch"):
        inner = getattr(eng, name)

        def capture(*a, inner=inner, name=name, **k):
            out = inner(*a, **k)
            if not first:
                first.append(np.array(out if name == "_guarded_forward"
                                      else a[0]))
            return out

        setattr(eng, name, capture)
    for i, p in enumerate(prompts):
        if sampling is None:
            eng.add_request(i, p, max_new)
        else:
            eng.submit(p, SamplingParams(max_new_tokens=max_new, **sampling),
                       request_id=i)
    # decode rows of each unified forward (tokens per decode row-forward)
    eng.smoke_decode_rows = rows = []
    inner_step = eng._forward_step

    def forward_step(plan, decode, inner_step=inner_step):
        rows.append(len(decode))
        return inner_step(plan, decode)

    eng._forward_step = forward_step
    # host seconds in the sampler (the batched draw, and the verifier's
    # walk over each verify chunk)
    eng.smoke_sampler_s = {"sample": 0.0, "verify": 0.0}
    for name, key in (("_sample_batch", "sample"),
                      ("_verify_tokens", "verify")):
        def timed(*a, inner=getattr(eng, name), key=key, **k):
            t0 = time.perf_counter()
            out = inner(*a, **k)
            eng.smoke_sampler_s[key] += time.perf_counter() - t0
            return out

        setattr(eng, name, timed)
    step_s = []
    prof = None
    while eng.sched.has_work and eng.steps < 10_000:
        if profile_steps and eng.steps + 1 == profile_steps[0]:
            from torch.profiler import ProfilerActivity
            prof = torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        try:
            eng.step()
        except SanitizerError as e:
            fail(f"sanitizer at step {eng.steps}: {e}")
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if prof is not None and eng.steps == profile_steps[1]:
            prof.__exit__(None, None, None)
            eng.smoke_launch_calls = sum(
                e.count for e in prof.key_averages()
                if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
            break
    return eng, first[0] if first else None, step_s


def check_spec_counts(eng, label: str):
    """Every drafted token was accepted or rolled back."""
    d, a, r = (eng.spec_draft_tokens, eng.spec_accepted_tokens,
               eng.spec_rollback_tokens)
    if d != a + r:
        fail(f"{label}: drafted {d} != accepted {a} + rolled back {r}")


def check_run(eng, n_req: int, max_new: int, vocab: int, label: str):
    c = eng.counters()
    if c["internal_errors"] or c["failed_count"] or c["last_error"]:
        fail(f"{label}: internal_errors={c['internal_errors']} "
             f"failed_count={c['failed_count']} last_error={c['last_error']}")
    done = {r.request_id: r for r in eng.sched.finished}
    for i in range(n_req):
        r = done.get(i)
        if r is None or r.state.value != "finished" or r.stop_reason \
                or len(r.generated) != max_new:
            fail(f"{label}: request {i} did not finish with {max_new} "
                 f"tokens ({None if r is None else (r.state, r.stop_reason, len(r.generated))})")
        if not all(0 <= t < vocab for t in r.generated):
            fail(f"{label}: request {i} produced out-of-vocab tokens")
    return {i: list(done[i].generated) for i in range(n_req)}


# the engine configurations the port serves: the default unified step, the
# reference's measured baselines and the paper's mixed W4Ax schedule
CONFIGS = {
    "unified work_queue": {},
    "split work_queue": dict(unified_step=False),
    "split dense": dict(unified_step=False, attention_schedule="dense"),
    "split work_queue ps128": dict(unified_step=False, page_size=128),
    "whole gather": dict(prefill_mode="whole", decode_attention="gather"),
    "unified dense": dict(attention_schedule="dense"),
    "unified work_queue mixed": {},
    "unified work_queue spec": {},
}
# the QuantConfig fields of a configuration beside impl
QUANT = {"unified work_queue mixed": dict(schedule="mixed")}
# the SamplingParams fields of a configuration beside max_new_tokens
SAMPLING = {"unified work_queue spec": dict(temperature=0.8, top_k=40,
                                            speculation=4)}


def seed_biases(torch, params, seed: int):
    """Seeded non-zero q/k/v biases, LayerNorm biases and norm scales off
    1, in place: the initializers' zeros and ones would let a dropped
    bias or norm parameter pass unseen."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def fill(t, scale, base=0.0):
        t.copy_(base + scale * torch.randn(t.shape, generator=gen,
                                           device="cuda"))

    norms = [params["final_norm"]]
    for bp in params["blocks"]:
        norms += [bp["attn_norm"], bp["mlp_norm"]]
        for key in ("wq", "wk", "wv"):
            if "b" in bp["attn"][key]:
                fill(bp["attn"][key]["b"], 0.5)
    for nrm in norms:
        if "bias" in nrm:
            fill(nrm["bias"], 0.1)
            fill(nrm["scale"], 0.1, 1.0)


# the parity phase's 2-layer d_model-1024 models: Llama-shaped, and shaped
# like Qwen2.5-32B (G = 5, QKV bias) and StarCoder2-15B (G = 12, QKV bias,
# LayerNorm, tanh-GELU)
PARITY_MODELS = {
    "llama-shaped": dict(num_heads=8, num_kv_heads=2, rope_theta=500_000.0),
    "qwen2.5-shaped": dict(num_heads=10, num_kv_heads=2, qkv_bias=True),
    "starcoder2-shaped": dict(num_heads=12, num_kv_heads=1, qkv_bias=True,
                              norm="layernorm", mlp_act="gelu",
                              rope_theta=100_000.0),
}


def phase_parity(torch, np, mods):
    """Each configuration served twice on each of ``PARITY_MODELS`` (2
    layers, d_model 1024, head_dim 128; the new shapes with seeded
    non-zero biases), with the kernels and with ``impl="ref"``: first
    logits within 2e-2·max|logit|, greedy agreement ≥ 0.9."""
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    for model, dims in PARITY_MODELS.items():
        cfg = ModelConfig(**{**dict(name=model, family="dense",
                                    num_layers=2, d_model=1024, head_dim=128,
                                    d_ff=2048, vocab_size=512), **dims})
        params = LM(cfg).init(seed=0, device="cuda")
        if model != "llama-shaped":
            seed_biases(torch, params, 11)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in (40, 7, 23, 64, 13, 29)]
        for label, kw in CONFIGS.items():
            ecfg = EngineConfig(**{**dict(max_batch=8, num_pages=128,
                                          page_size=64, max_pages_per_seq=16,
                                          prefill_chunk_tokens=48,
                                          kv_range=4.0), **kw})
            res = {}
            for impl in ("auto", "ref"):
                eng, first, _ = serve(torch, np, Engine, EngineConfig,
                                      QuantConfig, cfg, params, impl,
                                      prompts, 16, ecfg,
                                      QUANT.get(label, {}),
                                      SAMPLING.get(label))
                tag = f"parity[{model}, {label}, {impl}]"
                res[impl] = (check_run(eng, len(prompts), 16, cfg.vocab_size,
                                       tag), first)
                check_spec_counts(eng, tag)
            (tk, lk), (tr, lr) = res["auto"], res["ref"]
            if lk is None or lk.shape != lr.shape:
                fail(f"parity[{model}, {label}]: first logits missing or "
                     f"mis-shaped")
            err = float(np.abs(lk - lr).max())
            tol = 2e-2 * float(np.abs(lr).max())
            if not err <= tol:
                fail(f"parity[{model}, {label}]: first logits max err {err} "
                     f"> {tol}")
            total = sum(len(v) for v in tr.values())
            agree = sum(a == b for i in tr
                        for a, b in zip(tk[i], tr[i])) / total
            say(f"[parity] {model} {label}: first logits max err {err:.4g} "
                f"(tol {tol:.4g}); {'token' if label in SAMPLING else 'greedy'}"
                f" agreement {agree:.4f} over {total} tokens")
            if agree < 0.9:
                fail(f"parity[{model}, {label}]: greedy agreement {agree} "
                     f"< 0.9")
        del params


def profile_table(torch, prof, wall_s: float, steps: int):
    """Top kernels by device time, the device busy share of the run, the
    kernel launches the host made per engine step (CUDA runtime and
    driver launch calls), and the top host operations by their own CPU
    time."""
    events = prof.key_averages()
    launch_calls = sum(e.count for e in events
                       if e.key.startswith(("cudaLaunchKernel",
                                            "cuLaunchKernel")))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # only the device's own events (kernels, copies); an aten op's device
    # time repeats the time of the kernels it launched
    on_dev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in on_dev) / 1e6
    lines = [f"device busy {busy:.3f} s of {wall_s:.3f} s wall "
             f"({100 * busy / wall_s:.1f} %) in "
             f"{sum(e.count for e in on_dev)} device events",
             f"kernel launch calls {launch_calls} in {steps} steps = "
             f"{launch_calls / max(steps, 1):.1f} per step",
             "top device time:"]
    for e in sorted(on_dev, key=dev_us, reverse=True)[:25]:
        lines.append(f"{dev_us(e) / 1e3:10.2f} ms {e.count:7d}x  {e.key[:90]}")
    lines.append("top host (self CPU) time:")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:20]:
        lines.append(f"{e.self_cpu_time_total / 1e3:10.2f} ms {e.count:7d}x  "
                     f"{e.key[:90]}")
    return "\n".join(lines)


ACT = ("act_quant_w4ax",)
SINGLE = ("act_quant_int4", "act_quant_int8")   # K1, K2 alone: off the path
SPLIT = ACT + ("w4a4_matmul", "w4a8_matmul")
MIXED = ACT + ("w4ax_matmul_mixed",)
# (run, configuration, the kernels it must launch, the kernels it must not)
RUNS = (
    ("slice", "unified work_queue",
     SPLIT + ("paged_kv4_prefill_attention_wq",),
     SINGLE + ("w4ax_matmul_mixed",)),
    ("a", "split work_queue", SPLIT + ("paged_kv4_prefill_attention",
                                       "paged_kv4_decode_attention_wq"),
     SINGLE),
    ("b", "split dense", SPLIT + ("paged_kv4_prefill_attention",
                                  "paged_kv4_decode_attention"), SINGLE),
    ("c", "whole gather", SPLIT + ("kv4_decode_attention",), SINGLE),
    ("d", "unified dense", SPLIT + ("paged_kv4_prefill_attention",), SINGLE),
    ("e", "unified work_queue mixed",
     MIXED + ("paged_kv4_prefill_attention_wq",),
     SINGLE + ("w4a4_matmul", "w4a8_matmul")),
)
# the run whose launches a kernel's row reports: the path it serves
PATH_OF = {"paged_kv4_decode_attention_wq": "a",
           "paged_kv4_decode_attention": "b", "kv4_decode_attention": "c",
           "paged_kv4_prefill_attention": "d", "w4ax_matmul_mixed": "e",
           "w4a4_matmul_experts": "moe", "w4a8_matmul_experts": "moe",
           "w4ax_matmul_mixed_experts": "moe mixed"}
# K1 and K2 run on the path as one launch of the fused op: their rows
# report its launches (and their own, 0, as ``launches_alone``)
COUNTED_AS = {"act_quant_int4": "act_quant_w4ax",
              "act_quant_int8": "act_quant_w4ax"}


def act_per_layer(cfg, quant_kw: dict) -> int:
    """Fused act-quant launches a layer a forward: one per distinct
    projection input — h (q/k/v), the attention output (wo), then h
    (up/gate) and the down projection's input; for an MoE layer instead
    the capacity buffers (expert gate/up) and the experts' activation
    (down), with shared experts also h and their down input; none under
    W4A16."""
    if quant_kw.get("weight_only"):
        return 0
    if cfg.family == "moe":
        return 4 + 2 * (cfg.num_shared_experts > 0)
    return ACT_PER_LAYER


# tokens/s of each serve_llama run by its tag (the moe phase prints W4A16
# beside W4Ax)
TOK_S: dict = {}


def serve_llama(torch, np, mods, KERNELS, cfg, params, run: str,
                profile=False, phase=None, quant_kw=None, must=None,
                never=None):
    """One run of the ``slice`` workload on ``cfg`` (Llama-3-8B at full
    width and depth; under ``phase="archs"`` or ``"moe"`` another
    configuration): 8 requests of 128–512 prompt tokens × 32 new tokens,
    greedy, ``prefill_chunk_tokens=256``, in the run's configuration
    (``quant_kw``: more ``QuantConfig`` fields; ``must``/``never``: the
    kernels in place of the run's). Launch counts are set to 0 just
    before and read just after; every request must finish with 32
    tokens, with no failed or internal errors, every kernel of the run
    must have launched and none it must not. → launches."""
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    label, must0, never0 = next((c, m, x) for r, c, m, x in RUNS
                                if r == run)
    must = must0 if must is None else must
    never = never0 if never is None else never
    quant_kw = {**QUANT.get(label, {}), **(quant_kw or {})}
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 513, 8)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist() for n in lens]
    ecfg = EngineConfig(prefill_chunk_tokens=256, **CONFIGS[label])
    gc.collect()      # earlier runs' engines (their KV pools) are garbage now
    torch.cuda.reset_peak_memory_stats()
    for kern in KERNELS.values():
        kern.launches = 0
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    eng, first, step_s = serve(torch, np, Engine, EngineConfig, QuantConfig,
                               cfg, params, "auto", prompts, 32, ecfg,
                               quant_kw)
    wall = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    w4a16 = " W4A16" if quant_kw.get("weight_only") else ""
    tag = (f"[{phase}] {cfg.name} × {cfg.num_layers} layers: {run}{w4a16} "
           f"({label})" if phase else
           f"[{'slice' if run == 'slice' else 'baselines'}] {run} ({label})")
    if prof is not None:
        prof.__exit__(None, None, None)
        say(f"{tag} profiled run (times include profiler overhead):\n"
            + profile_table(torch, prof, wall, eng.steps))
    check_run(eng, len(prompts), 32, cfg.vocab_size, tag)
    if first is None or not np.isfinite(first).all():
        fail(f"{tag}: first logits missing or not finite")
    for name in must:
        if launches[name] <= 0:
            fail(f"{tag}: kernel {name} was never launched")
    for name in never:
        if launches[name]:
            fail(f"{tag}: kernel {name} launched {launches[name]} times; "
                 f"this configuration must not reach it")
    per = act_per_layer(cfg, quant_kw)
    want = per * cfg.num_layers * eng.forward_calls
    if launches["act_quant_w4ax"] != want:
        fail(f"{tag}: act_quant_w4ax launched {launches['act_quant_w4ax']} "
             f"times, not {per} × {cfg.num_layers} layers × "
             f"{eng.forward_calls} forwards = {want}")
    if eng.attn_forwards <= 0 and label != "whole gather":
        fail(f"{tag}: no forward attended over paged history")
    toks = eng.tokens_generated
    TOK_S[tag] = toks / wall
    say(f"{tag} prompts {lens.tolist()}; {eng.steps} steps, "
        f"{eng.forward_calls} forwards, {toks} tokens in {wall:.3f} s = "
        f"{toks / wall:.2f} tok/s; median step "
        f"{statistics.median(step_s) * 1e3:.2f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"{tag} step ms {[round(x * 1e3, 2) for x in step_s]}")
    say(f"{tag} launches {json.dumps(launches)}")
    say(f"{tag} counters {json.dumps(eng.counters())}")
    return launches


# the spec phase: Llama-3-8B, 8 requests whose prompts repeat one seeded
# 24-token pattern up to 128–512 tokens, 32 new tokens each, sanitizers on
SPEC_PATTERN = 24
SPEC_FAULTS = "draft:nth=3,action=raise;verify:nth=2;forward:step=14,action=nan"
SPEC_CHUNK = 256           # the prefill budget a step
SPEC_RUNS = (   # run, SamplingParams fields, fault schedule, attention
    #             schedule
    ("a", dict(speculation=0), None, "work_queue"),
    ("b", dict(speculation=4), None, "work_queue"),
    ("c", dict(temperature=0.8, top_k=40, speculation=3), None, "work_queue"),
    ("c again", dict(temperature=0.8, top_k=40, speculation=3), None,
     "work_queue"),
    ("d", dict(speculation=4), SPEC_FAULTS, "work_queue"),
    ("a dense", dict(speculation=0), None, "dense"),
    ("b dense", dict(speculation=4), None, "dense"),
)
# greedy runs held against the spec-off run of their schedule: (b) must
# agree token for token, (b dense)'s agreement is reported
SPEC_AGAINST = {"b": "a", "b dense": "a dense"}
SPEC_MUST = SPLIT + ("paged_kv4_prefill_attention_wq",)


def spec_prompts(np, vocab: int):
    rng = np.random.default_rng(0)
    pattern = rng.integers(1, vocab, SPEC_PATTERN).tolist()
    lens = rng.integers(128, 513, 8)
    return [(pattern * (int(n) // SPEC_PATTERN + 1))[:int(n)]
            for n in lens], lens


def phase_spec(torch, np, mods, KERNELS, cfg, params):
    """Speculative decode, stochastic sampling and fault injection on the
    unified step at Llama-3-8B's full width and depth, under the
    sanitizers (``SPEC_RUNS``): (a) greedy; (b) greedy with 4 drafts a
    row; (c) T = 0.8, top_k 40, 3 drafts, served twice; (d) (b) under
    ``SPEC_FAULTS``; (a) and (b) under the dense attention schedule.
    Each run: no internal error, a sanitizer pass every step, the pages
    back to the pool, the path's kernels launched and the fused
    act-quant 4 × layers × forwards times; every run but (d) every
    request 32 tokens; (b) accepted drafts, drafted = accepted + rolled
    back, fewer forwards than (a) and the same tokens as (a), every one;
    (c) the same tokens twice; (d) one draft error and exactly the
    failures its fired faults cause; (b dense)'s agreement with (a
    dense) printed. → the launches of run (b)."""
    from repro_torch.serving.faults import FaultInjector
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    prompts, lens = spec_prompts(np, cfg.vocab_size)
    n_req, max_new = len(prompts), 32
    out, forwards = {}, {}
    for run, sampling, schedule, attn in SPEC_RUNS:
        tag = f"[spec] {run}"
        ecfg = EngineConfig(prefill_chunk_tokens=SPEC_CHUNK, sanitize=True,
                            attention_schedule=attn)
        fi = FaultInjector.from_spec(schedule) if schedule else None
        gc.collect()
        for kern in KERNELS.values():
            kern.launches = 0
        t0 = time.perf_counter()
        eng, first, step_s = serve(torch, np, Engine, EngineConfig,
                                   QuantConfig, cfg, params, "auto", prompts,
                                   max_new, ecfg, {}, sampling, fi)
        wall = time.perf_counter() - t0
        launches = {name: kern.launches for name, kern in KERNELS.items()}
        c = eng.counters()
        if c["internal_errors"] or c["sanitize_checks"] != c["steps"]:
            fail(f"{tag}: internal_errors={c['internal_errors']} "
                 f"sanitize_checks={c['sanitize_checks']} of {c['steps']} "
                 f"steps; last_error={c['last_error']}")
        check_spec_counts(eng, tag)
        if eng.cache.pages_free != ecfg.num_pages:
            fail(f"{tag}: {eng.cache.pages_free} pages free or reclaimable "
                 f"after the run, of {ecfg.num_pages}")
        if first is None or not np.isfinite(first).all():
            fail(f"{tag}: first logits missing or not finite")
        must = (SPEC_MUST if attn == "work_queue" else
                SPLIT + ("paged_kv4_prefill_attention",))
        for name in must:
            if launches[name] <= 0:
                fail(f"{tag}: kernel {name} was never launched")
        want = ACT_PER_LAYER * cfg.num_layers * eng.forward_calls
        if launches["act_quant_w4ax"] != want:
            fail(f"{tag}: act_quant_w4ax launched "
                 f"{launches['act_quant_w4ax']} times, not {want}")
        done = {r.request_id: r for r in eng.sched.finished}
        if schedule is None:
            toks = check_run(eng, n_req, max_new, cfg.vocab_size, tag)
        else:
            fired = fi.fired
            want_failed = sum(1 for p, a, _ in fired
                              if p == "verify" or (p == "forward"
                                                   and a == "nan"))
            if c["draft_errors"] != 1 or c["failed_count"] != want_failed:
                fail(f"{tag}: draft_errors={c['draft_errors']} (want 1), "
                     f"failed_count={c['failed_count']} (fired {fired})")
            for i in range(n_req):
                r = done.get(i)
                if r is None or (r.state.value != "failed"
                                 and len(r.generated) != max_new):
                    fail(f"{tag}: request {i} neither failed nor finished "
                         f"with {max_new} tokens")
            toks = {i: list(done[i].generated) for i in range(n_req)}
        decode_rows = sum(eng.smoke_decode_rows)
        per_row = (eng.tokens_generated - n_req) / max(decode_rows, 1)
        acc = c["spec_accepted_tokens"] / max(c["spec_draft_tokens"], 1)
        line = (f"{tag} {sampling}{' faults ' + schedule if schedule else ''}"
                f": {eng.steps} steps, {eng.forward_calls} forwards, "
                f"{eng.tokens_generated} tokens in {wall:.3f} s = "
                f"{eng.tokens_generated / wall:.2f} tok/s; median step "
                f"{statistics.median(step_s) * 1e3:.2f} ms; "
                f"{per_row:.4f} tokens per decode row-forward "
                f"({decode_rows} decode row-forwards); drafted "
                f"{c['spec_draft_tokens']} accepted "
                f"{c['spec_accepted_tokens']} (acceptance {acc:.4f}) rolled "
                f"back {c['spec_rollback_tokens']}; host sampler "
                f"{eng.smoke_sampler_s['sample'] * 1e3 / eng.steps:.3f} + "
                f"verifier {eng.smoke_sampler_s['verify'] * 1e3 / eng.steps:.3f}"
                f" ms a step")
        agree = None
        if run in SPEC_AGAINST and schedule is None:
            ref = out[SPEC_AGAINST[run]]
            total = sum(len(v) for v in ref.values())
            agree = sum(x == y for i in ref
                        for x, y in zip(ref[i], toks[i])) / total
            line += f"; agreement with ({SPEC_AGAINST[run]}) {agree:.4f}"
        say(line)
        if run == "b" and agree != 1.0:
            ref = out["a"]
            first = {i: next(j for j, (x, y) in enumerate(zip(ref[i],
                                                               toks[i]))
                             if x != y)
                     for i in ref if ref[i] != toks[i]}
            fail(f"{tag}: greedy speculation agrees with (a) on "
                 f"{agree:.4f} of the tokens, not all (request: first "
                 f"token that differs {first})")
        say(f"{tag} launches {json.dumps(launches)}")
        if schedule:
            say(f"{tag} fired {fi.fired}; counters {json.dumps(c)}")
        out[run], forwards[run] = toks, eng.forward_calls
        if run == "b":
            launches_b = launches
        if run == "b":
            if c["spec_accepted_tokens"] <= 0:
                fail(f"{tag}: no draft was accepted")
            if forwards["b"] >= forwards["a"]:
                fail(f"{tag}: {forwards['b']} forwards, not fewer than "
                     f"(a)'s {forwards['a']}")
        if run == "c again" and toks != out["c"]:
            fail(f"{tag}: the stochastic run did not replay its tokens")
        del eng
    return launches_b


def phase_specdiag(torch, np, mods, cfg, params):
    """Where a token's computation as a qlen-1 decode row and as a position
    of a verify chunk part: the ``spec`` workload served greedily until
    all 8 rows decode; then, over the same state, forwards of the unified
    body with the output of every op recorded (norms, projections, RoPE,
    in-flight fake-quant, attention, SiLU, the lm head): (A) every row its
    last token alone, (B) every row that token and 4 drafts, (Ai) every
    row its i-th draft alone, i positions later, over the history B
    wrote (i = 1..4). A's token is held against B's position 0, Ai's
    against B's position i: per op, in call order, the largest difference
    and the rows that differ, then the first op that differs; any op
    that differs fails the phase. Last, the norm and the lm head on rows
    0–7 of a 64-row input against the same rows alone."""
    from repro_torch.kernels import ops
    from repro_torch.layers import common as C
    from repro_torch.core import quantizer as Q
    from repro_torch.layers import mlp as MLP
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    prompts, _ = spec_prompts(np, cfg.vocab_size)
    eng = Engine(cfg, params, QuantConfig(), EngineConfig(
        prefill_chunk_tokens=256), device="cuda")
    for i, p in enumerate(prompts):
        eng.add_request(i, p, 32)
    while not (len(eng.sched.running) == len(prompts) and all(
            r.prefilled and r.generated for r in eng.sched.running)):
        eng.step()
    rows = list(eng.sched.running)
    n, ndraft = len(rows), SPEC_C - 1
    ctx = np.asarray([int(eng.cache.seq_len[r.seq_slot]) for r in rows])
    for r, c in zip(rows, ctx):
        eng.cache.grow_to(r.seq_slot, int(c) + 1 + ndraft)
    chunks = [[r.generated[-1]] + r.prompt[:ndraft] for r in rows]

    def forward(offset: int, take: int):
        """Every row's chunk tokens [offset, offset + take) at positions
        ctx + offset.., over ctx + offset keys of history."""
        starts = ctx + offset
        takes = np.full(n, take)
        cum = np.concatenate([[0], np.cumsum(takes)])
        tok_seq = np.repeat(np.arange(n), takes)
        tok_off = np.concatenate([np.arange(t) for t in takes])
        tokens = np.concatenate([c[offset:offset + take] for c in chunks])
        return eng._guarded_forward(
            [], starts, takes, np.asarray([r.seq_slot for r in rows]), cum,
            tok_seq, tok_off, starts[tok_seq] + tok_off,
            tokens.astype(np.int64), np.arange(int(cum[-1])), [])

    targets = [(C, "apply_norm"), (C, "linear"), (C, "linears"),
               (C, "apply_rope"), (Q, "qdq_kv_with"), (MLP, "silu_bf16"),
               (ops, "paged_kv4_prefill_attention_wq")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    recs = {}
    # A, then B (its chunk's KV written at ctx.. ctx + 4), then A1..A4
    for key, offset, take in ((("A", 0, 1), ("B", 0, 1 + ndraft))
                              + tuple((f"A{i}", i, 1)
                                      for i in range(1, 1 + ndraft))):
        rec = recs[key] = []
        for mod, name, fn in saved:
            def wrapped(*a, fn=fn, name=name, rec=rec, **kw):
                out = fn(*a, **kw)
                outs = out if isinstance(out, (tuple, list)) else (out,)
                rec.append((name, [o.detach().clone() for o in outs]))
                return out

            setattr(mod, name, wrapped)
        try:
            forward(offset, take)
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def compare(key, pos):
        """``key``'s single tokens against B's chunk position ``pos``."""
        if [nm for nm, _ in recs[key]] != [nm for nm, _ in recs["B"]]:
            fail("specdiag: the forwards called different ops")
        first, norms = None, 0      # two norms a layer, then the final one
        for (name, outs_a), (_, outs_b) in zip(recs[key], recs["B"]):
            norms += name == "apply_norm"
            layer = (norms - 1) // 2
            for oa, ob in zip(outs_a, outs_b):
                if name == "paged_kv4_prefill_attention_wq":
                    ta, tb = oa[:n, 0], ob[:n, pos]
                else:
                    ta, tb = oa[0, :n], ob[0, pos:n * SPEC_C:SPEC_C]
                diff = float((ta.float() - tb.float()).abs().max())
                nrows = int(sum(not torch.equal(ta[j], tb[j])
                                for j in range(n)))
                say(f"[specdiag] {key} vs B position {pos}: layer {layer} "
                    f"{name}: max diff {diff:.6g}, {nrows} of {n} rows "
                    f"differ")
                if nrows and first is None:
                    first = f"layer {layer} {name}"
        say(f"[specdiag] {key} vs B position {pos}: first op whose output "
            f"differs: {first}")
        return first

    differ = {pos: compare("A" if pos == 0 else f"A{pos}", pos)
              for pos in range(1 + ndraft)}
    # row-wise ops on 8 rows alone against the same rows first and last
    # in T-row inputs (a step's token count decides T)
    gen = torch.Generator(device=eng.device).manual_seed(9)
    x = (torch.randn((1, 1024, cfg.d_model), generator=gen,
                     device=eng.device) * 2).bfloat16()
    norm = params["final_norm"]
    bp = params["blocks"][0]
    quant = eng.quant
    for label, fn in (
            ("rmsnorm", lambda t: C.apply_norm(norm, t, cfg.norm,
                                               cfg.norm_eps)),
            ("lm head", lambda t: eng.lm.head(params, t)),
            ("q/k/v", lambda t: torch.cat(C.linears(
                [bp["attn"][w] for w in ("wq", "wk", "wv")], t, quant), -1)),
            ("mlp", lambda t: MLP.mlp_apply(bp["mlp"], t, quant,
                                            cfg.mlp_act))):
        alone = fn(x[:, :8])
        for t in (16, 32, 64, 128, 256, 512, 1024):
            y = x[:, :t].clone()
            y[:, t - 8:] = x[:, :8]
            out = fn(y)
            first, last = out[:, :8], out[:, t - 8:]
            say(f"[specdiag] {label}: rows alone vs first/last 8 of {t}: "
                f"equal={torch.equal(alone, first)}/"
                f"{torch.equal(alone, last)} max diff "
                f"{float((alone.float() - first.float()).abs().max()):.6g}/"
                f"{float((alone.float() - last.float()).abs().max()):.6g}")
    del eng
    gc.collect()
    # the spec runs (a) and (b), every op of each decode token traced and
    # compared where the two runs hold the same tokens
    sa, ra = spec_trace(torch, np, mods, cfg, params, {}, SPEC_CHUNK)
    sb, rb = spec_trace(torch, np, mods, cfg, params, dict(speculation=4),
                        SPEC_CHUNK)
    say(f"[specdiag] traced (a) and (b): first "
        f"difference {spec_trace_compare(torch, sa, ra, sb, rb)}")
    del ra, rb
    gc.collect()
    if any(differ.values()):
        fail(f"specdiag: a verify position is not its decode step: {differ}")


def spec_trace(torch, np, mods, cfg, params, sampling, chunk: int):
    """Serve the spec workload greedily under ``sampling`` and record, for
    every decode-row token and layer, the residual stream into each norm,
    K9's query, in-flight key and value and output, the wo projection and
    the MLP's output, with the chunk the token rode in → (every request's
    prompt + generated tokens, {(request, position): [(chunk start, chunk
    tokens, [(op, tensor) per call in layer order])]})."""
    from repro_torch.kernels import ops
    from repro_torch.layers import common as C
    from repro_torch.layers import mlp as MLP
    from repro_torch.serving.api import SamplingParams
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    prompts, _ = spec_prompts(np, cfg.vocab_size)
    eng = Engine(cfg, params, QuantConfig(), EngineConfig(
        prefill_chunk_tokens=chunk), device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(p, SamplingParams(max_new_tokens=32, **sampling),
                   request_id=i)
    rec, calls = {}, []
    # (module, function, what is recorded: its first argument or output,
    # packed [1, T] or padded [rows, chunk] token layout)
    targets = ((C, "apply_norm", "in"), (C, "linear", "out"),
               (C, "linears", "outs"), (C, "apply_rope", "out"),
               (MLP, "mlp_apply", "out"),
               (ops, "paged_kv4_prefill_attention_wq", "k9"))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

    def wrap(fn, name, what):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            if what == "in":
                calls.append((name, "packed", a[1]))
                calls.append((name + " out", "packed", out))
            elif what == "outs":
                calls.extend((f"{name} {i}", "packed", o)
                             for i, o in enumerate(out))
            elif what == "out":
                calls.append((name, "packed", out))
            else:
                calls.append((name + " q", "padded", a[0]))
                calls.append((name + " k", "padded", a[1]))
                calls.append((name + " v", "padded", a[2]))
                calls.append((name + " out", "padded", out))
            return out
        return wrapped

    inner_fwd = eng._guarded_forward

    def fwd(plan, starts, takes, slots, cum, tok_seq, tok_off, tok_pos,
            tokens, *a):
        calls.clear()
        out = inner_fwd(plan, starts, takes, slots, cum, tok_seq, tok_off,
                        tok_pos, tokens, *a)
        # the layer norms only (the final norm reads the logit rows)
        norm_at = [k for k, c in enumerate(calls)
                   if c[0].startswith("apply_norm")]
        layer_calls = [c for k, c in enumerate(calls)
                       if k not in norm_at[4 * cfg.num_layers:]]
        by_slot = {r.seq_slot: r.request_id for r in eng.sched.running}
        for si in range(len(plan), len(starts)):
            chunk_toks = tokens[cum[si]:cum[si + 1]].tolist()
            for off in range(int(takes[si])):
                j = int(cum[si]) + off
                rec.setdefault((by_slot[int(slots[si])],
                                int(starts[si]) + off), []).append(
                    (int(starts[si]), chunk_toks[:off + 1],
                     [(name, (t[si, off] if lay == "padded" else t[0, j])
                       .clone()) for name, lay, t in layer_calls]))
        return out

    eng._guarded_forward = fwd
    for mod, name, what in targets:
        setattr(mod, name, wrap(getattr(mod, name), name, what))
    try:
        eng.run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    seqs = {r.request_id: list(r.prompt) + list(r.generated)
            for r in eng.sched.finished}
    del eng
    return seqs, rec


def spec_trace_compare(torch, seqs_a, rec_a, seqs_b, rec_b):
    """The first (request, position) whose recorded tensors differ between
    two traces, over the positions both runs reached with the same tokens
    (a record counts if its chunk's tokens are the run's own sequence):
    → a line naming it and the first op (in call order) that differs, or
    None."""
    found = []
    for rid in sorted(seqs_a):
        a, b = seqs_a[rid], seqs_b[rid]
        same = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
        for (r, pos), recs in sorted(rec_a.items()):
            if r != rid or pos >= same:
                continue
            ok_b = [x for x in rec_b.get((r, pos), [])
                    if x[1] == b[x[0]:pos + 1]]
            ok_a = [x for x in recs if x[1] == a[x[0]:pos + 1]]
            if not ok_a or not ok_b:
                continue
            names = [n for n, _ in ok_a[0][2]]
            for k, ((name, xa), (_, xb)) in enumerate(zip(ok_a[0][2],
                                                          ok_b[0][2])):
                if not torch.equal(xa, xb):
                    found.append((pos, rid, k, name, names[:k].count(name),
                                  ok_a[0][0], ok_b[0][0], float(
                                      (xa.float() - xb.float()).abs().max())))
                    break
    if not found:
        return None
    pos, rid, k, name, nth, ca, cb, diff = min(found)
    return (f"request {rid} position {pos} (chunks from {ca} and {cb}): "
            f"call {nth} of {name} differs by {diff:.6g} ({len(found)} "
            f"positions differ)")


# the recover and replicas phases: the spec workload (8 prompts × 32 new
# tokens, greedy with 4 drafts a row, again at T = 0.8 from the top 40)
# on pools sized to it (the default 512 pages would make each snapshot
# ~1.4 GB of JSON), a checkpoint every 4 engine steps
RECOVER_PAGES, REPLICA_PAGES, SNAP_EVERY = 80, 48, 4
RECOVER_RUNS = (("greedy", dict(speculation=4)),
                ("T=0.8", dict(temperature=0.8, top_k=40, speculation=4)))
REPLICA_CRASH = 6          # replica 1 dies before its 6th engine step
# recover and replicas serve Llama-3-8B at full width and these of its 32
# layers (their contracts are per step, not per layer); 8, not 4: the spec
# workload's greedy run drafts nothing at 4 layers, and the recover phase
# stops after the first drafts
DURABLE_LAYERS = 8
RECOVER_MESH_SIZES = (1, 2)            # the mesh form's world sizes
REPLICA_MESH = (2, 2)                  # replicas × ranks of the mesh form


def durable_model(cfg, params):
    """Llama-3-8B cut to ``DURABLE_LAYERS`` layers: its first blocks (the
    seed draws the top, then block after block, so they are the blocks a
    ``DURABLE_LAYERS``-layer init draws)."""
    return (dataclasses.replace(cfg, num_layers=DURABLE_LAYERS),
            {**params, "blocks": params["blocks"][:DURABLE_LAYERS]})


def _serve_plain(torch, Engine, EngineConfig, QuantConfig, cfg, params,
                 prompts, sp, ecfg):
    """The uninterrupted run: every request's tokens."""
    eng = Engine(cfg, params, QuantConfig(), ecfg, device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(p, sp, request_id=i)
    eng.run()
    check_spec_counts(eng, "[recover] uninterrupted")
    out = {r.request_id: list(r.generated) for r in eng.sched.finished}
    del eng
    return out


def _streams(events, n_req: int, label: str):
    """Each request's delivered tokens from ``events``; exactly one
    terminal each, ``finished``."""
    toks = {i: [] for i in range(n_req)}
    terms = {i: [] for i in range(n_req)}
    for ev in events:
        if ev.token is not None:
            toks[ev.request_id].append(int(ev.token))
        elif ev.finished:
            terms[ev.request_id].append(ev)
    for i, t in terms.items():
        if len(t) != 1 or t[0].state.value != "finished":
            fail(f"{label}: request {i} got {len(t)} terminal events "
                 f"({[e.state.value for e in t]})")
    return toks


def _free_memory(torch):
    """Return a dropped engine's memory (its pools) to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_recover(torch, np, mods, cfg, params):
    """Journaled crash recovery at Llama-3-8B's full width and
    ``DURABLE_LAYERS`` layers: the spec workload (greedy with 4 drafts, then at T = 0.8), each served
    once uninterrupted and once through a directory-backed
    ``RecoveryLog(snapshot_every=4)`` stopped, after the first drafts,
    two steps past a checkpoint; the engine is dropped and its memory
    freed, the log rebuilt with ``RecoveryLog.open_dir`` and run to the
    end. No
    ``ReplayMismatch``, replayed events > 0, the pages back to the pool,
    and at T = 0.8 every request's delivered stream the uninterrupted
    run's token for token with one terminal. In the greedy run the
    resumed log has ``snapshot_write`` (action ``torn``) armed on its
    second checkpoint: the torn write must leave the last good
    ``snapshot.json``, and a second ``open_dir`` from it must finish with
    every request's tokens the uninterrupted run's (the events of the
    torn step were journaled but never returned, so the reference's log
    never delivers them: see ROADMAP). Prints the snapshot's bytes and
    the seconds to take and restore it."""
    import tempfile
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.faults import Fault, FaultInjector, InjectedFault
    from repro_torch.serving.recovery import RecoveryLog, ReplayMismatch
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    prompts, _ = spec_prompts(np, cfg.vocab_size)
    n_req, max_new = len(prompts), 32
    ecfg = EngineConfig(prefill_chunk_tokens=256, num_pages=RECOVER_PAGES)

    def open_dir(d, faults=None):
        return RecoveryLog.open_dir(d, cfg, params, QuantConfig(), ecfg,
                                    snapshot_every=SNAP_EVERY,
                                    device="cuda", faults=faults)

    for run, fields in RECOVER_RUNS:
        tag = f"[recover] {run}"
        t_run = time.perf_counter()
        sp = SamplingParams(max_new_tokens=max_new, **fields)
        want = _serve_plain(torch, Engine, EngineConfig, QuantConfig, cfg,
                            params, prompts, sp, ecfg)
        with tempfile.TemporaryDirectory() as d:
            eng = Engine(cfg, params, QuantConfig(), ecfg, device="cuda")
            log = RecoveryLog(eng, snapshot_every=SNAP_EVERY, dir=d)
            for i, p in enumerate(prompts):
                eng.submit(p, sp, request_id=i)
            delivered = []
            # past the first drafts (truncate_seq state in the snapshots),
            # then to two steps past a checkpoint
            while not eng.spec_draft_tokens or eng.steps % SNAP_EVERY != 2:
                if not eng.sched.has_work:
                    fail(f"{tag}: the workload ended before a draft")
                delivered.extend(log.step())
            drafted = eng.spec_draft_tokens
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blob = eng.snapshot(full=True)
            snap_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            Engine.restore(blob, cfg, params, QuantConfig(), ecfg,
                           device="cuda")
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            pool_bytes = 2 * eng.cache.k_pool.numel()
            say(f"{tag}: stopped at engine step {eng.steps} (checkpoint at "
                f"{log.snapshot_step}), {drafted} drafts so far, journal "
                f"{len(log.journal)} events; a full snapshot is "
                f"{len(blob)} bytes of JSON for {pool_bytes} pool bytes "
                f"({RECOVER_PAGES} pages), taken in {snap_s:.3f} s, "
                f"restored in {restore_s:.3f} s")
            if not drafted:
                fail(f"{tag}: no draft before the stop")
            del blob, eng, log
            _free_memory(torch)
            torn = None
            try:
                log = open_dir(d, FaultInjector(
                    [Fault("snapshot_write", nth=3, action="torn")])
                    if run == "greedy" else None)
                try:
                    delivered += log.run()
                except InjectedFault:
                    torn = log.engine.steps
                    with open(os.path.join(d, "snapshot.json")) as f:
                        good = json.loads(f.read())["steps"]
                    replayed = log.replayed
                    say(f"{tag}: snapshot_write torn at the step-{torn} "
                        f"checkpoint; snapshot.json holds step {good}")
                    if good >= torn or not os.path.exists(
                            os.path.join(d, "snapshot.json.tmp")):
                        fail(f"{tag}: the torn write did not leave the "
                             f"last good snapshot (step {good}, torn at "
                             f"{torn})")
                    del log
                    _free_memory(torch)
                    log = open_dir(d)
                    if log.engine.steps != good:
                        fail(f"{tag}: resumed at step {log.engine.steps}, "
                             f"not the last good snapshot's {good}")
                    delivered += log.run()
                    replayed += log.replayed
                else:
                    replayed = log.replayed
                    if run == "greedy":
                        fail(f"{tag}: the armed torn write never fired")
            except ReplayMismatch as e:
                fail(f"{tag}: {e}")
            eng = log.engine
            if replayed <= 0:
                fail(f"{tag}: nothing replayed after the restore")
            if torn is None:
                got = _streams(delivered, n_req, tag)
                what = "delivered stream"
            else:
                got = {r.request_id: list(r.generated)
                       for r in eng.sched.finished}
                what = "tokens"
            bad = [i for i in range(n_req) if got.get(i) != want[i]]
            if bad:
                fail(f"{tag}: requests {bad}: {what} not the uninterrupted "
                     f"run's")
            if eng.cache.pages_free != RECOVER_PAGES or eng.internal_errors:
                fail(f"{tag}: {eng.cache.pages_free} of {RECOVER_PAGES} "
                     f"pages free, internal_errors {eng.internal_errors}")
            say(f"{tag}: resumed, {replayed} events replayed and verified "
                f"bit for bit, every request's {what} equal to the "
                f"uninterrupted run's, pages back "
                f"({time.perf_counter() - t_run:.1f} s)")
            del log, eng
            _free_memory(torch)


def recover_rank(rank: int, world: int, device, cfg, root: str) -> dict:
    """One rank of the recover phase's mesh form (a spawned process, NCCL):
    its shard of the seeded weights, then the greedy spec workload through
    a directory-backed ``RecoveryLog`` under ``root`` served uninterrupted,
    crashed two steps past a checkpoint after the first drafts and resumed
    with ``open_dir``, and torn at its third snapshot write and resumed
    from the last good snapshot → each run's streams and counts."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.lm import LM, QuantConfig
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.faults import Fault, FaultInjector, InjectedFault
    from repro_torch.serving.recovery import RecoveryLog
    mesh = make_local_mesh(1, world)
    lm = LM(cfg)
    params = lm.init(seed=0, device=device, mesh=mesh)
    kw = dict(device=device, mesh=mesh, param_axes=lm.axes(params))
    prompts, _ = spec_prompts(np, cfg.vocab_size)
    n_req = len(prompts)
    sp = SamplingParams(max_new_tokens=32, **RECOVER_RUNS[0][1])
    ecfg = EngineConfig(prefill_chunk_tokens=256, num_pages=RECOVER_PAGES,
                        sanitize=True)
    tag = f"[recover] mesh M={world} rank {rank}"

    def new_log(d, faults=None):
        eng = Engine(cfg, params, QuantConfig(), ecfg, faults=faults, **kw)
        log = RecoveryLog(eng, snapshot_every=SNAP_EVERY, dir=d)
        for i, p in enumerate(prompts):
            eng.submit(p, sp, request_id=i)
        return log

    def open_dir(d):
        return RecoveryLog.open_dir(d, cfg, params, QuantConfig(), ecfg,
                                    snapshot_every=SNAP_EVERY, **kw)

    def done(log, label):
        eng = log.engine
        if eng.cache.pages_free != RECOVER_PAGES or eng.internal_errors:
            fail(f"{tag} {label}: {eng.cache.pages_free} of {RECOVER_PAGES} "
                 f"pages free, internal_errors {eng.internal_errors}")
        return {"tokens": {r.request_id: list(r.generated)
                           for r in eng.sched.finished},
                "replayed": log.replayed, "steps": eng.steps,
                "drafted": eng.spec_draft_tokens}

    out = {}
    log = new_log(os.path.join(root, "plain"))
    out["plain"] = {"streams": _streams(log.run(), n_req, f"{tag} plain"),
                    **done(log, "plain")}
    d = os.path.join(root, "crash")
    log = new_log(d)
    delivered = []
    while not log.engine.spec_draft_tokens or \
            log.engine.steps % SNAP_EVERY != 2:
        if not log.engine.sched.has_work:
            fail(f"{tag}: the workload ended before a draft")
        delivered.extend(log.step())
    out["crash_at"] = (log.engine.steps, log.snapshot_step)
    del log
    _free_memory(torch)
    log = open_dir(d)
    out["resumed_at"] = log.engine.steps
    delivered.extend(log.run())
    out["crash"] = {"streams": _streams(delivered, n_req, f"{tag} crash"),
                    **done(log, "crash")}
    d = os.path.join(root, "torn")
    log = new_log(d, FaultInjector([Fault("snapshot_write", nth=3,
                                          action="torn")]))
    try:
        log.run()
        fail(f"{tag}: the armed torn write never fired")
    except InjectedFault:
        torn = log.engine.steps
    with open(os.path.join(d, "snapshot.json")) as f:
        good = json.loads(f.read())["steps"]
    out["torn"] = {"at": torn, "good": good,
                   "tmp": os.path.exists(os.path.join(d,
                                                      "snapshot.json.tmp"))}
    import torch.distributed as dist
    dist.barrier(group=mesh.host_group)    # every rank read the good one
    del log
    _free_memory(torch)
    log = open_dir(d)
    out["torn"].update(resumed_at=log.engine.steps)
    log.run()
    out["torn"].update(done(log, "torn"))
    return out


def phase_recover_mesh(torch, cfg):
    """The recover phase over tensor-parallel meshes of
    ``RECOVER_MESH_SIZES`` ranks, as the cards allow (the others named):
    :func:`recover_rank` on each rank, spawned through the real NCCL
    group. Every rank's delivered streams after the crash and resume must
    be the uninterrupted mesh run's token for token, the torn write must
    leave the last good snapshot (rank 0's torn temp file beside it) and
    its resume finish with the uninterrupted tokens; replayed events > 0,
    the pages back, every rank alike."""
    import tempfile
    from repro_torch.launch.mesh import spawn
    cards = torch.cuda.device_count()
    sizes = [w for w in RECOVER_MESH_SIZES if w <= cards]
    say(f"[recover] mesh world sizes run: {sizes}"
        + (f"; not run: {[w for w in RECOVER_MESH_SIZES if w > cards]} "
           f"({cards} visible card(s))" if len(sizes) < len(
               RECOVER_MESH_SIZES) else ""))
    for world in sizes:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as root:
            try:
                res = spawn(recover_rank, world, (cfg, root),
                            device_type="cuda", timeout_s=900.0)
            except (RuntimeError, TimeoutError, ValueError) as e:
                fail(f"[recover] mesh M={world}: {e}")
        tag = f"[recover] mesh M={world}"
        r0 = res[0]
        if any({k: v for k, v in r.items()} != r0 for r in res[1:]):
            fail(f"{tag}: the ranks' runs differ")
        plain, crash, torn = r0["plain"], r0["crash"], r0["torn"]
        if crash["streams"] != plain["streams"]:
            bad = [i for i in plain["streams"]
                   if crash["streams"].get(i) != plain["streams"][i]]
            fail(f"{tag}: requests {bad}: delivered stream after the crash "
                 f"and resume not the uninterrupted mesh run's")
        if not (torn["good"] == torn["resumed_at"] < torn["at"]
                and torn["tmp"]):
            fail(f"{tag}: the torn write did not leave the last good "
                 f"snapshot ({torn})")
        if torn["tokens"] != plain["tokens"]:
            fail(f"{tag}: tokens after the torn write's resume not the "
                 f"uninterrupted mesh run's")
        if min(crash["replayed"], torn["replayed"]) <= 0 or \
                not crash["drafted"]:
            fail(f"{tag}: nothing replayed or drafted ({crash}, {torn})")
        say(f"{tag} ({cfg.num_layers} layers, NCCL): crashed at engine step "
            f"{r0['crash_at'][0]} (checkpoint {r0['crash_at'][1]}), resumed "
            f"at {r0['resumed_at']}, {crash['replayed']} events replayed and "
            f"verified, every request's delivered stream the uninterrupted "
            f"mesh run's; snapshot_write torn at step {torn['at']}, "
            f"snapshot.json at {torn['good']}, resumed with "
            f"{torn['replayed']} replayed and the uninterrupted tokens; "
            f"every rank alike ({time.perf_counter() - t0:.1f} s with the "
            f"ranks' start-up)")


def replicas_rank(rank: int, world: int, device, cfg, m: int) -> dict:
    """One rank of the replicas phase's mesh form: ``world // m`` replica
    meshes of ``m`` ranks, its replica's shard of the seeded weights, and
    the group of :func:`replica_group` under each failover policy with
    replica 1 killed → each policy's streams and counts."""
    from repro_torch.launch.mesh import make_replica_meshes
    from repro_torch.models.lm import LM
    meshes = make_replica_meshes(world // m, m)
    lm = LM(cfg)
    params = lm.init(seed=0, device=device, mesh=meshes[rank // m])
    return {policy: replica_group(cfg, params, policy, meshes=meshes,
                                  param_axes=lm.axes(params))
            for policy in ("standby", "migrate")}


def replica_group(cfg, params, policy: str, **mesh_kw) -> dict:
    """Two replicas behind a ``ReplicaGroup`` serving the spec workload
    greedy with 4 drafts, replica 1 killed before its ``REPLICA_CRASH``th
    step under ``policy`` (on the one card, or over ``meshes``) → each
    request's delivered tokens and terminal, the counters and deaths."""
    from repro_torch.models.lm import QuantConfig
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.faults import Fault, FaultInjector
    from repro_torch.serving.replication import ReplicaGroup
    prompts, _ = spec_prompts(np, cfg.vocab_size)
    group = ReplicaGroup(
        cfg, params, QuantConfig(),
        EngineConfig(prefill_chunk_tokens=256, num_pages=REPLICA_PAGES),
        replicas=2, failover=policy, snapshot_every=SNAP_EVERY,
        faults=[FaultInjector(),
                FaultInjector([Fault("crash", step=REPLICA_CRASH)])],
        device=params["embed"]["table"].device, **mesh_kw)
    rids = [group.submit(p, SamplingParams(max_new_tokens=32,
                                           speculation=4))
            for p in prompts]
    group.run()
    return {"tokens": {r: group.tokens_for(r) for r in rids},
            "terminals": {r: group.terminal_for(r).state.value
                          for r in rids},
            "counters": group.counters(), "deaths": list(group.deaths)}


def phase_replicas_mesh(torch, cfg, params):
    """The replicas phase over per-replica meshes: where ``REPLICA_MESH``
    (2 replicas × 2 ranks) cards exist, :func:`replicas_rank` on four
    spawned ranks (NCCL), replica 1 killed under each failover policy;
    every rank's streams, terminals, counters and deaths must be those of
    the same group with both replicas on the one card, its row-parallel
    projections summed as two ranks' seams (``serial_seams(2)``). On fewer
    cards: not run, and why."""
    from repro_torch.launch.mesh import spawn
    r, m = REPLICA_MESH
    cards = torch.cuda.device_count()
    if cards < r * m:
        say(f"[replicas] mesh {r} x (1x{m}): not run ({cards} visible "
            f"card(s), {r * m} needed)")
        return
    t0 = time.perf_counter()
    try:
        res = spawn(replicas_rank, r * m, (cfg, m), device_type="cuda",
                    timeout_s=900.0)
    except (RuntimeError, TimeoutError, ValueError) as e:
        fail(f"[replicas] mesh {r} x (1x{m}): {e}")
    with serial_seams(m):
        want = {policy: replica_group(cfg, params, policy)
                for policy in ("standby", "migrate")}
    for policy, w in want.items():
        tag = f"[replicas] mesh {r} x (1x{m}) {policy}"
        if w["counters"]["failovers"] != 1:
            fail(f"{tag}: the one-card group failed over "
                 f"{w['counters']['failovers']} times")
        for rank, got in enumerate(res):
            if got[policy] != w:
                bad = [k for k in w if got[policy][k] != w[k]]
                fail(f"{tag}: rank {rank}'s {bad} not the one-card group's")
        say(f"{tag} ({cfg.num_layers} layers): every rank's streams, "
            f"terminals, counters {json.dumps(w['counters'])} and deaths "
            f"{w['deaths']} those of the group on the one card under "
            f"serial_seams({m}) ({time.perf_counter() - t0:.1f} s)")


def phase_replicas(torch, np, mods, cfg, params):
    """Two replicas on the one card behind a ``ReplicaGroup`` (Llama-3-8B at
    full width and ``DURABLE_LAYERS`` layers, ``snapshot_every=4``, pools of ``REPLICA_PAGES`` pages each, one set
    of weights) serving the spec workload greedy with 4 drafts: without a
    crash, then with ``crash`` armed on replica 1 before its 6th engine
    step under ``standby`` (every request's delivered tokens those of the
    run without the crash; failovers 1) and under ``migrate`` (one
    terminal per request, 32 tokens each, failovers 1, requests moved).
    No internal error, the live replicas' pages back. Prints the peak
    device memory beside the weights and the pools."""
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.faults import Fault, FaultInjector
    from repro_torch.serving.recovery import ReplayMismatch
    from repro_torch.serving.replication import ReplicaGroup
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    prompts, _ = spec_prompts(np, cfg.vocab_size)
    n_req, max_new = len(prompts), 32
    ecfg = EngineConfig(prefill_chunk_tokens=256, num_pages=REPLICA_PAGES)
    sp = SamplingParams(max_new_tokens=max_new, speculation=4)
    weights = tree_bytes(params)
    ref = None
    for policy in ("none", "standby", "migrate"):
        tag = f"[replicas] {policy}"
        faults = [FaultInjector(), FaultInjector(
            [Fault("crash", step=REPLICA_CRASH)] if policy != "none" else [])]
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        group = ReplicaGroup(cfg, params, QuantConfig(), ecfg, replicas=2,
                             failover=("standby" if policy == "none"
                                       else policy),
                             snapshot_every=SNAP_EVERY, faults=faults,
                             device="cuda")
        rids = [group.submit(p, sp) for p in prompts]
        try:
            group.run()
        except ReplayMismatch as e:
            fail(f"{tag}: {e}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        pools = sum(2 * r.engine.cache._k_pages.numel()
                    for r in group.replicas)
        c = group.counters()
        toks = {rid: group.tokens_for(rid) for rid in rids}
        say(f"{tag}: {c['replica_steps']} replica steps, failovers "
            f"{c['failovers']}, migrated {c['migrated_requests']}, "
            f"duplicates suppressed {c['duplicates_suppressed']}, health "
            f"{c['health']}, deaths {group.deaths}; {wall:.1f} s; peak "
            f"device memory {peak} bytes (weights {weights}, two replicas' "
            f"pools {pools})")
        if c["internal_errors"]:
            fail(f"{tag}: internal_errors {c['internal_errors']}")
        if len(group.terminals) != n_req or any(
                group.terminal_for(r).state.value != "finished"
                for r in rids):
            fail(f"{tag}: not exactly one finished terminal per request")
        if any(len(t) != max_new for t in toks.values()):
            fail(f"{tag}: not {max_new} tokens delivered per request")
        for rep in group.replicas:
            if rep.alive and rep.engine.cache.pages_free != REPLICA_PAGES:
                fail(f"{tag}: replica {rep.idx}'s pages not back")
        if peak >= weights + pools + weights:
            fail(f"{tag}: peak memory {peak} would hold the weights twice")
        if policy == "none":
            if c["failovers"]:
                fail(f"{tag}: a failover without a crash")
            ref = toks
        else:
            if c["failovers"] != 1:
                fail(f"{tag}: {c['failovers']} failovers, not 1")
            if policy == "standby" and toks != ref:
                bad = [r for r in rids if toks[r] != ref[r]]
                fail(f"{tag}: requests {bad} delivered other tokens than "
                     f"the group run without the crash")
            if policy == "migrate" and c["migrated_requests"] <= 0:
                fail(f"{tag}: no request migrated")
        del group
        _free_memory(torch)


# the archs phase: Llama-3-70B at full depth; the others at full width,
# their depth cut to ARCH_DEPTH layers, in these runs (Qwen2.5-32B at
# G = 5 and StarCoder2-15B at G = 12 through every decode path)
ARCH_DEPTH = 4
ARCH_RUNS = (("mistral_nemo_12b", ("slice",)), ("qwen2_72b", ("slice",)),
             ("qwen2p5_32b", ("slice", "a", "b", "c")),
             ("starcoder2_15b", ("slice", "a", "b", "c")))
LLAMA70B_PACKED_GB = 40.5   # 68.45 B params at 4 bits + f32 scales + bf16
                            # embedding and head, reckoned by hand


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.nbytes


def phase_archs(torch, np, mods, KERNELS, get_config, profile=False):
    """Llama-3-70B at full width and depth (80 layers), then the other
    dense configurations at full width and ``ARCH_DEPTH`` layers, random
    seeded weights (biases and LayerNorm parameters seeded non-zero),
    each serving the ``slice`` workload with the checks of
    :func:`serve_llama` (every request 32 tokens, finite logits, the
    path's kernels launched, the fused act-quant 4 × layers × forwards
    times, K1 and K2 alone never)."""
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    cfg = get_config("llama3_70b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    packed = tree_bytes(params)
    say(f"[archs] {cfg.name}: random W4 weights ({cfg.num_layers} layers) "
        f"made in {made:.1f} s; packed model {packed / 1e9:.2f} GB "
        f"(reckoned ≈ {LLAMA70B_PACKED_GB} GB); peak device memory while "
        f"making them {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    serve_llama(torch, np, mods, KERNELS, cfg, params, "slice", profile,
                phase="archs")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for arch, runs in ARCH_RUNS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=ARCH_DEPTH)
        t0 = time.perf_counter()
        params = LM(cfg).init(seed=0, device="cuda")
        seed_biases(torch, params, 12)
        torch.cuda.synchronize()
        say(f"[archs] {cfg.name}: full width (d_model {cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab_size}, norm {cfg.norm}, MLP {cfg.mlp_act}, "
            f"QKV bias {cfg.qkv_bias}), depth cut {full.num_layers} → "
            f"{cfg.num_layers} layers; weights made in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{tree_bytes(params) / 1e9:.2f} GB")
        for run in runs:
            serve_llama(torch, np, mods, KERNELS, cfg, params, run,
                        phase="archs")
        del params
        gc.collect()
        torch.cuda.empty_cache()


# -------------------------------------------------------------------- MoE

# (model, E, (K, N) of the gate/up stacks and of the down stack, the
# capacities C = max(int(1.25·T·k/E), 4) at T = 8, 256 and 2,048 tokens)
MOE_GEMMS = (("Moonlight", 64, ((2048, 1408), (1408, 2048)), (4, 30, 240)),
             ("Qwen3-MoE", 128, ((4096, 1536), (1536, 4096)), (4, 20, 160)))
MOE_MAIN = ("Moonlight", 2048, 1408, 240)   # the rows' own shape
MOE_KERNELS = {"w4a4_matmul_experts": "src/repro/kernels/w4ax_matmul.py:142",
               "w4a8_matmul_experts": "src/repro/kernels/w4ax_matmul.py:209",
               "w4ax_matmul_mixed_experts":
               "src/repro/kernels/w4ax_matmul.py:288"}
EXPERTS = ("w4a4_matmul_experts", "w4a8_matmul_experts")
MOE_PARITY = (("moonshot_v1_16b_a3b", ("unified work_queue",
                                       "unified work_queue mixed",
                                       "whole gather")),
              ("qwen3_moe_235b_a22b", ("unified work_queue",
                                       "unified work_queue mixed")))
MOONLIGHT_PACKED_GB = 16.3   # 13.3 GB of W4 experts, 0.8 GB of their
                             # scales, ~0.9 GB shared experts and
                             # attention, 1.34 GB bf16 embedding and head
QWEN3_DEPTH = 4              # of 94 layers (~122 GB packed: not one card;
#                              8 until the train phase's mesh form took
#                              the time)
MOONLIGHT_W4A16_DEPTH = 24   # of 48: the W4A16 rerun of Moonlight's
#                              weights (its W4Ax run stays at full depth)


def expert_times(torch, Q, x, name: str, kern, ref, args) -> dict:
    """One expert-batched GEMM's times on these operands: the kernel, its
    plain version, one bf16 ``torch.bmm`` on the dequantized weights of
    the same K range (the yardstick), and its bound: every operand read
    once and the output written once, or 2·E·C·K·N int8 operations."""
    e, c = args[0].shape[:2]
    wp, ws = args[-2], args[-1]
    n, kk = wp.shape[2], wp.shape[1] * 2
    lo = x.shape[2] - kk if name == "w4a8_matmul_experts" else 0
    xb = x[:, :, lo:lo + kk].contiguous()
    wb = Q.dequantize_weight_int4(wp, ws).bfloat16()
    nbytes = sum(t.numel() * t.element_size() for t in args) + e * c * n * 4
    ops_ = 2 * e * c * n * kk
    return {"ms": time_ms(torch, lambda: kern(*args)),
            # the plain version: median of 5 (it takes up to 35 ms a call)
            "plain_ms": time_ms(torch, lambda: ref(*args), iters=5,
                                warmup=1),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            ops_ / INT8_OPS_PER_S) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops_ / INT8_OPS_PER_S else "operations"),
            "library_ms": time_ms(torch, lambda: torch.bmm(xb, wb))}


def check_moe_kernels(torch, AQ, WK, Q, rows: dict):
    """The expert-batched K3, K4 (the split schedule's pair) and K5 at
    Moonlight's and Qwen3-MoE's expert shapes (``MOE_GEMMS``; int4 share
    0.875, rounded half to even: 14+2, 10+1, 28+4 and 10+2 blocks), on
    bf16 capacity buffers whose last quarter of slots is empty (zero
    rows), act-quantized by the fused kernel: each ``torch.equal`` to its
    plain version and to a loop of the single-expert kernel over the
    experts, the split pair's sum to the split plain version; each timed
    with its bound and a bf16 ``torch.bmm``. The rows' own numbers are
    at ``MOE_MAIN``, the rest under ``experts``."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    for model, e, shapes, caps in MOE_GEMMS:
        for k, n in shapes:
            nb = k // 128
            nb4 = int(round(0.875 * nb))
            k4, k4p = nb4 * 128, nb4 * 64
            w = (torch.randn((e, k, n), generator=gen, device="cuda")
                 / k ** 0.5)
            wp, ws = Q.quantize_weight_int4(w)
            del w
            w4, ws4 = wp[:, :k4p], ws[:, :nb4]
            w8, ws8 = wp[:, k4p:], ws[:, nb4:]
            for c in caps:
                x = torch.randn((e, c, k), generator=gen,
                                device="cuda").bfloat16()
                x[:, c - max(1, c // 4):] = 0          # empty slots
                a4, s4, a8, s8 = (t.reshape(e, c, t.shape[-1]) for t in
                                  AQ.act_quant_w4ax(x.reshape(e * c, k), k4))
                forms = (
                    ("w4a4_matmul_experts", WK.w4a4_matmul_experts,
                     WK.w4a4_matmul_ref, WK.w4a4_matmul, (a4, s4, w4, ws4)),
                    ("w4a8_matmul_experts", WK.w4a8_matmul_experts,
                     WK.w4a8_matmul_ref, WK.w4a8_matmul, (a8, s8, w8, ws8)),
                    ("w4ax_matmul_mixed_experts", WK.w4ax_matmul_mixed_experts,
                     WK.w4ax_matmul_mixed_ref, WK.w4ax_matmul_mixed,
                     (a4, s4, a8, s8, wp, ws)))
                shape = (f"{model} E={e} C={c} N={n} K={k} "
                         f"({nb4}+{nb - nb4} blocks)")
                for name, kern, ref, one, args in forms:
                    got, want = kern(*args), ref(*args)
                    loop = torch.stack([one(*(t[i].contiguous() for t in args))
                                        for i in range(e)])
                    torch.cuda.synchronize()
                    for other, what in ((want, "its plain version"),
                                        (loop, "the per-expert loop")):
                        if not torch.equal(got, other):
                            fail(f"{name} {shape}: not bit-exact against "
                                 f"{what} (max err "
                                 f"{float((got - other).abs().max())})")
                    entry = {"shape": shape, "max_abs_err": 0.0,
                             **expert_times(torch, Q, x, name, kern, ref,
                                            args)}
                    if name == "w4ax_matmul_mixed_experts":
                        entry["split_ms"] = time_ms(
                            torch, lambda: WK.w4ax_matmul_split_experts(
                                a4, s4, a8, s8, wp, ws))
                    if (model, k, n, c) == MOE_MAIN:
                        rows[name] = {"name": name, "route": "cuda",
                                      "source":
                                      "src/repro_torch/csrc/w4ax_matmul.cu",
                                      "replaces": MOE_KERNELS[name], **entry,
                                      "experts": rows.get(name, {}).get(
                                          "experts", [])}
                    else:
                        rows.setdefault(name, {}).setdefault(
                            "experts", []).append(entry)
                    say(f"[moe] {name} {shape}: exact (plain, per-expert "
                        f"loop); {entry['ms']:.4f} ms, plain "
                        f"{entry['plain_ms']:.4f}, bound "
                        f"{entry['bound_ms']:.4f} ({entry['bound_by']}), "
                        f"bf16 bmm {entry['library_ms']:.4f}"
                        + (f", split pair {entry['split_ms']:.4f}"
                           if "split_ms" in entry else ""))
                split = WK.w4ax_matmul_split_experts(a4, s4, a8, s8, wp, ws)
                want = WK.w4ax_matmul_ref(a4, s4, a8, s8, w4, ws4, w8, ws8)
                torch.cuda.synchronize()
                if not torch.equal(split, want):
                    fail(f"w4ax_matmul_split_experts {shape}: not bit-exact "
                         f"against its plain version")
            del wp, ws, w4, ws4, w8, ws8


def moe_parity(torch, np, mods, KERNELS, get_config) -> dict:
    """Both MoE configurations at full width and 2 layers on the card, in
    the ``MOE_PARITY`` configurations, each served with the kernels and
    with ``impl="ref"`` on the parity phase's prompts: the same tokens
    (agreement 1.0000) and first logits with error 0 (the kernels are
    exact, the MoE glue is the same code on both), and pairs dropped by
    capacity in the default configuration. → the kernels' launches in the
    mixed run of the first model."""
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    mixed_launches = {}
    for arch, labels in MOE_PARITY:
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        params = LM(cfg).init(seed=0, device="cuda")
        rng = np.random.default_rng(1)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in (40, 7, 23, 64, 13, 29)]
        for label in labels:
            ecfg = EngineConfig(**{**dict(max_batch=8, num_pages=128,
                                          page_size=64, max_pages_per_seq=16,
                                          prefill_chunk_tokens=48,
                                          kv_range=4.0), **CONFIGS[label]})
            res = {}
            for impl in ("auto", "ref"):
                for kern in KERNELS.values():
                    kern.launches = 0
                eng, first, _ = serve(torch, np, Engine, EngineConfig,
                                      QuantConfig, cfg, params, impl,
                                      prompts, 16, ecfg, QUANT.get(label, {}),
                                      count_drops=True)
                dropped = int(sum(int(d) for d in eng.moe_dropped))
                tag = f"moe parity[{cfg.name} × 2, {label}, {impl}]"
                res[impl] = (check_run(eng, len(prompts), 16, cfg.vocab_size,
                                       tag), first, dropped)
                if impl == "auto" and label == "unified work_queue mixed" \
                        and not mixed_launches:
                    mixed_launches = {n: k.launches
                                      for n, k in KERNELS.items()}
            (tk, lk, dk), (tr, lr, dr) = res["auto"], res["ref"]
            if lk is None or lk.shape != lr.shape:
                fail(f"moe parity[{cfg.name}, {label}]: first logits missing "
                     f"or mis-shaped")
            err = float(np.abs(lk - lr).max())
            total = sum(len(v) for v in tr.values())
            agree = sum(a == b for i in tr
                        for a, b in zip(tk[i], tr[i])) / total
            say(f"[moe] parity {cfg.name} × 2 layers {label}: first logits "
                f"max err {err:.4g}; greedy agreement {agree:.4f} over "
                f"{total} tokens; (token, expert) pairs dropped by capacity "
                f"{dk} (kernels), {dr} (ref)")
            if err != 0.0 or agree != 1.0 or dk != dr:
                fail(f"moe parity[{cfg.name}, {label}]: the kernel path must "
                     f"equal the plain one (err {err}, agreement {agree}, "
                     f"dropped {dk} vs {dr})")
            if label == "unified work_queue" and dk <= 0:
                fail(f"moe parity[{cfg.name}]: no step dropped a pair")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if not mixed_launches.get("w4ax_matmul_mixed_experts"):
        fail("moe parity: the mixed run never launched "
             "w4ax_matmul_mixed_experts")
    return mixed_launches


def moe_model(torch, LM, cfg, note: str):
    """Random seeded W4 weights of ``cfg`` made on the card block by
    block → (params, packed GB), the time and peak memory printed."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    gb = tree_bytes(params) / 1e9
    say(f"[moe] {cfg.name} ({note}): d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {cfg.num_experts} "
        f"experts top-{cfg.num_experts_per_tok}, {cfg.num_shared_experts} "
        f"shared, expert d_ff {cfg.moe_d_ff}, QK-norm {cfg.qk_norm}; "
        f"weights made in {time.perf_counter() - t0:.1f} s, packed "
        f"{gb:.2f} GB; peak while making them "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return params, gb


def moe_launch_calls(torch, np, mods, cfg, params, steps=(5, 6)) -> float:
    """Kernel launch calls a step of the ``slice`` workload on ``cfg``
    (``torch.profiler`` over ``steps``, a run of its own so the
    profiler's cost stays out of the times)."""
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(128, 513, 8)]
    eng, _, _ = serve(torch, np, Engine, EngineConfig, QuantConfig, cfg,
                      params, "auto", prompts, 32,
                      EngineConfig(prefill_chunk_tokens=256), {},
                      profile_steps=steps)
    return eng.smoke_launch_calls / (steps[1] - steps[0] + 1)


def phase_moe(torch, np, mods, KERNELS, get_config, AQ, WK, Q, rows,
              params8b, smi: str) -> dict:
    """(a) the expert-batched GEMMs (:func:`check_moe_kernels`); (b)
    kernel against plain paths on 2-layer MoE models
    (:func:`moe_parity`); (c) Moonlight-16B-A3B at full width and depth
    serving ``slice``, with its launch calls a step, peak memory and
    packed bytes; (d) Qwen3-MoE-235B-A22B at full width and
    ``QWEN3_DEPTH`` layers, the same; (e) ``slice`` under W4A16
    (``weight_only``) on Llama-3-8B and Moonlight beside their W4Ax
    runs. → launches of the runs whose counts the kernel table reports:
    ``moe`` (Moonlight, the default configuration), ``moe mixed``."""
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    t0 = time.perf_counter()

    def lap(part: str):
        say(f"[time] moe {part}: {time.perf_counter() - t0:.1f} s in")

    check_moe_kernels(torch, AQ, WK, Q, rows)
    lap("(a) kernels")
    mixed = moe_parity(torch, np, mods, KERNELS, get_config)
    lap("(b) parity")
    moe_must = SPLIT + EXPERTS + ("paged_kv4_prefill_attention_wq",)
    moe_never = SINGLE + ("w4ax_matmul_mixed", "w4ax_matmul_mixed_experts")
    w4a16_must = ("paged_kv4_prefill_attention_wq",)
    w4a16_never = (ACT + SINGLE + SPLIT[1:] + EXPERTS
                   + ("w4ax_matmul_mixed", "w4ax_matmul_mixed_experts"))

    cfg = get_config("moonshot_v1_16b_a3b")
    params, gb = moe_model(torch, LM, cfg, f"full depth, reckoned ≈ "
                           f"{MOONLIGHT_PACKED_GB} GB packed")
    launches = serve_llama(torch, np, mods, KERNELS, cfg, params, "slice",
                           phase="moe", must=moe_must, never=moe_never)
    calls = moe_launch_calls(torch, np, mods, cfg, params)
    say(f"[moe] {cfg.name} × {cfg.num_layers} layers: {calls:.1f} kernel "
        f"launch calls a step (steps 5–6); packed {gb:.2f} GB | {smi}")
    cut = dataclasses.replace(
        cfg, num_layers=MOONLIGHT_W4A16_DEPTH,
        name=f"{cfg.name} [{MOONLIGHT_W4A16_DEPTH} of {cfg.num_layers} "
             f"layers]")
    serve_llama(torch, np, mods, KERNELS, cut,
                {**params, "blocks": params["blocks"][:cut.num_layers]},
                "slice", phase="moe", quant_kw={"weight_only": True},
                must=w4a16_must, never=w4a16_never)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    lap("(c) Moonlight")

    full = get_config("qwen3_moe_235b_a22b")
    cfg = dataclasses.replace(
        full, num_layers=QWEN3_DEPTH,
        name=f"{full.name} [{QWEN3_DEPTH} of {full.num_layers} layers]")
    params, gb = moe_model(torch, LM, cfg, f"depth cut {full.num_layers} → "
                           f"{QWEN3_DEPTH}")
    serve_llama(torch, np, mods, KERNELS, cfg, params, "slice", phase="moe",
                must=moe_must, never=moe_never)
    calls = moe_launch_calls(torch, np, mods, cfg, params)
    say(f"[moe] {cfg.name}: {calls:.1f} kernel launch calls a step (steps "
        f"5–6); packed {gb:.2f} GB | {smi}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    lap("(d) Qwen3-MoE")

    serve_llama(torch, np, mods, KERNELS, get_config("llama3_8b"), params8b,
                "slice", phase="moe", quant_kw={"weight_only": True},
                must=w4a16_must, never=w4a16_never)
    for tag, tps in TOK_S.items():
        say(f"[moe] tok/s {tps:.2f}: {tag} | {smi}")
    return {"moe": launches, "moe mixed": mixed}


# ------------------------------------------- the model's own path, FMPQ

GEN_BATCH, GEN_PROMPT, GEN_STEPS, GEN_MAX_LEN = 8, 512, 32, 1024
# K10 timed on the generate run's cache: T = GEN_MAX_LEN slots, the rows
# at these lengths (the run's own are 512 + 32)
GEN_K10_LENS = (512, 517, 521, 526, 530, 535, 539, 544)


def generate(torch, LM, QuantConfig, cfg, params, quant_kw, tokens,
             steps: int, extra=None):
    """``LM.prefill`` of ``tokens`` (with ``extra``: image embeddings)
    into a fresh ``GEN_MAX_LEN`` cache, then ``steps`` greedy ``decode``
    steps → (logits [B, 1 + steps, V] on the card, tokens [B, steps],
    prefill s, seconds per decode step, the cache)."""
    lm = LM(cfg, QuantConfig(**quant_kw))
    cache = lm.init_cache(tokens.shape[0], GEN_MAX_LEN, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, tokens, cache, extra)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out, toks, step_s = [logits[:, -1]], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        tok = logits[:, -1].argmax(-1)
        logits, cache = lm.decode(params, tok[:, None], cache)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        toks.append(tok)
        out.append(logits[:, -1])
    return (torch.stack(out, 1), torch.stack(toks, 1), prefill_s, step_s,
            cache)


def gen_tokens(torch, np, vocab: int, b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(1, vocab, (b, s))).cuda()


def kernels_vs_ref(torch, LM, QuantConfig, cfg, params, quant_kw, tokens,
                   steps: int, label: str):
    """The same generate run with the kernels and with ``impl="ref"`` on
    the card: the same tokens and logits with error 0."""
    got = generate(torch, LM, QuantConfig, cfg, params, quant_kw, tokens,
                   steps)
    want = generate(torch, LM, QuantConfig, cfg, params,
                    {**quant_kw, "impl": "ref"}, tokens, steps)
    err = float((got[0] - want[0]).abs().max())
    same = bool(torch.equal(got[1], want[1]))
    say(f"{label}: kernels against impl='ref': logits max err {err:.4g} "
        f"over {tuple(got[0].shape)}; tokens equal {same}")
    if err != 0.0 or not same:
        fail(f"{label}: the kernel path must equal the plain one (err "
             f"{err}, tokens equal {same})")


def check_k10(torch, KA, Q, q, c, rows: dict, key: str, tag: str,
              note: str = "") -> dict:
    """K10 on queries ``q`` over a layer's int4 cache ``c`` (T slots, the
    rows at ``GEN_K10_LENS``), bit for bit against its plain version,
    timed beside it, SDPA on the gathered dequantized KV and the byte
    bound: the K10 row's ``key`` entry."""
    import torch.nn.functional as TF
    b, hq, d = q.shape
    hkv, t = c["k_packed"].shape[1], c["k_packed"].shape[2]
    g = hq // hkv
    lengths = torch.tensor(GEN_K10_LENS, dtype=torch.int32, device="cuda")
    args = (q, c["k_packed"], c["k_scale"], c["k_zero"], c["v_packed"],
            c["v_scale"], c["v_zero"], lengths)
    op = lambda: KA.kv4_decode_attention(*args)            # noqa: E731
    ref = lambda: KA.kv4_decode_attention_ref(*args)       # noqa: E731
    err = check_exact(f"kv4_decode_attention {key}", op(), ref(),
                      [(i, hq) for i in range(b)])
    top = max(GEN_K10_LENS)
    yk, yv = [repeat_heads(Q.dequantize_kv_channelwise(
        x[:, :, :top], s, z).bfloat16(), g).contiguous()
        for x, s, z in ((c["k_packed"], c["k_scale"], c["k_zero"]),
                        (c["v_packed"], c["v_scale"], c["v_zero"]))]
    mask = (torch.arange(top, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    yq = q[:, :, None, :].contiguous()
    library_ms = time_ms(torch, lambda: TF.scaled_dot_product_attention(
        yq, yk, yv, attn_mask=mask))
    scales = 4 * hkv * d * 4
    entry = {"shape": f"B={b} Hq={hq} Hkv={hkv} G={g} D={d} T={t} "
                      f"lengths {GEN_K10_LENS[0]}–{GEN_K10_LENS[-1]}{note}",
             "max_abs_err": err, "ms": time_ms(torch, op),
             "plain_ms": time_ms(torch, ref),
             **bound(*decode_bound(GEN_K10_LENS, hq, hkv, d,
                                   scales + lengths.nbytes)),
             "library_ms": library_ms,
             "rows": KA.dense_plan(b, 1, g, hkv, 1, t, d).rows}
    put(rows, "kv4_decode_attention",
        key if "kv4_decode_attention" in rows else None, entry)
    say(f"{tag} K10 at D={d} T={t}, lengths {GEN_K10_LENS}{note}: max err "
        f"{err}; {entry['ms']:.6f} ms (plain {entry['plain_ms']:.6f}, SDPA "
        f"{library_ms:.6f}, bound {entry['bound_ms']:.6f})")
    return entry


def check_k10_generate(torch, KA, Q, cfg, cache, rows: dict):
    """K10 over the generate run's layer-0 cache (T = ``GEN_MAX_LEN``):
    the K10 row's ``generate T=1024`` entry."""
    c = cache["attn"][0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((c["k_packed"].shape[0], cfg.num_heads, cfg.head_dim),
                    generator=gen, device="cuda").bfloat16()
    check_k10(torch, KA, Q, q, c, rows, "generate T=1024", "[generate]")


def phase_generate(torch, np, mods, KERNELS, KA, Q, cfg8b, params, rows,
                   smi: str) -> dict:
    """The model's own path: Llama-3-8B at full width and depth (the
    ``slice`` weights), ``LM.init_cache(8, 1024)`` with ``kv4``,
    ``prefill`` of 8 prompts × 512 tokens, 32 greedy ``decode`` steps
    (K10 32 × 32 times, the fused act-quant 4 × 32 a forward, K1 and K2
    alone never, finite logits); K10 on its cache at T = 1,024; then at
    2 layers the same run with the kernels and with ``impl="ref"`` (the
    same tokens, error 0), under ``kv4`` and on the bf16 cache (no
    K10). → the full-depth run's launches."""
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    tokens = gen_tokens(torch, np, cfg8b.vocab_size, GEN_BATCH, GEN_PROMPT, 2)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    for kern in KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    logits, toks, prefill_s, step_s, cache = generate(
        torch, LM, QuantConfig, cfg8b, params, {}, tokens, GEN_STEPS)
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in KERNELS.items()}
    layers, fwd = cfg8b.num_layers, 1 + GEN_STEPS
    tag = f"[generate] {cfg8b.name} × {layers} layers"
    if not torch.isfinite(logits).all():
        fail(f"{tag}: non-finite logits")
    want = {"kv4_decode_attention": GEN_STEPS * layers,
            "act_quant_w4ax": ACT_PER_LAYER * layers * fwd,
            "act_quant_int4": 0, "act_quant_int8": 0}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{tag}: {name} launched {launches[name]} times, not {n}")
    for name in SPLIT[1:]:
        if launches[name] <= 0:
            fail(f"{tag}: {name} was never launched")
    for name, n in launches.items():
        if n and name not in want and name not in SPLIT:
            fail(f"{tag}: {name} launched {n} times off the model's path")
    new = GEN_BATCH * GEN_STEPS
    say(f"{tag}: prefill {GEN_BATCH} × {GEN_PROMPT} tokens in "
        f"{prefill_s * 1e3:.2f} ms; {GEN_STEPS} decode steps, median "
        f"{statistics.median(step_s) * 1e3:.2f} ms, {new / sum(step_s):.2f} "
        f"decode tok/s, {(new + GEN_BATCH) / wall:.2f} tok/s with the "
        f"prefill; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB | {smi}")
    say(f"{tag} first row's tokens {toks[0].tolist()}")
    say(f"{tag} launches {json.dumps(launches)}")
    check_k10_generate(torch, KA, Q, cfg8b, cache, rows)
    rows["kv4_decode_attention"]["launches_generate"] = launches[
        "kv4_decode_attention"]
    del cache, logits
    cfg2 = dataclasses.replace(cfg8b, num_layers=2)
    params2 = {**params, "blocks": params["blocks"][:2]}
    kernels_vs_ref(torch, LM, QuantConfig, cfg2, params2, {}, tokens,
                   GEN_STEPS, "[generate] 2 layers, int4 cache")
    for kern in KERNELS.values():
        kern.launches = 0
    kernels_vs_ref(torch, LM, QuantConfig, cfg2, params2, {"kv4": False},
                   tokens, GEN_STEPS, "[generate] 2 layers, bf16 cache")
    if KERNELS["kv4_decode_attention"].launches:
        fail("[generate] the bf16 cache path launched K10")
    return launches


# ---------------------------------------------- the other model families

# Zamba2's decode attention: B = 8, 32 query and kv heads (G = 1), head_dim
# 80, a 1,024-slot cache holding 512–544 keys
K10_D80 = (8, 32, 32, 80, 1024)


def check_k10_d80(torch, KA, Q, rows: dict):
    """K10 at head_dim 80 (Zamba2-2.7B's attention) on a seeded cache of
    ``K10_D80``: the K10 row's ``D=80`` entry."""
    b, hq, hkv, d, t = K10_D80
    gen = torch.Generator(device="cuda").manual_seed(24)
    c = {f"{n}_packed": torch.randint(0, 256, (b, hkv, t, d // 2),
                                      generator=gen, device="cuda",
                                      dtype=torch.uint8) for n in "kv"}
    for n in "kv":
        c[f"{n}_scale"] = 0.05 + 0.15 * torch.rand(
            (hkv, 1, d), generator=gen, device="cuda")
        c[f"{n}_zero"] = 6 + 3 * torch.rand((hkv, 1, d), generator=gen,
                                            device="cuda")
    q = torch.randn((b, hq, d), generator=gen, device="cuda").bfloat16()
    check_k10(torch, KA, Q, q, c, rows, "D=80", "[kernels]",
              " (Zamba2-2.7B)")


# (arch, depth of the full-width run or None for the config's, what the
# run does); the VLM cut to 10 of its 100 layers (2 groups of 4 self
# layers and a cross layer) for the phase's time
FAMILY_RUNS = (("zamba2_2p7b", None, "generate"),
               ("rwkv6_1p6b", None, "generate"),
               ("llama3p2_vision_90b", 10, "generate"),
               ("hubert_xlarge", None, "encode"))
FAMILY_GATE = 0.5        # the VLM's cross gates (0 at init: tanh(0) = 0)
# fused act-quant launches per layer of each kind and forward: the hybrid's
# shared attention block 4 (q/k/v, wo, up/gate, down) per group and a Mamba2
# layer 2 (in_proj, out_proj); an RWKV layer 8 (r, k, v, g, w_o; the
# channel-mix's k, v, r); a VLM self layer 4, a cross layer 5 at prefill
# (q, the image K/V once for the attention and the cache, wo, up/gate,
# down) and 4 at decode (the image K/V cached)


def family_act_quant(cfg, lm, mode: str) -> int:
    fam = cfg.family
    if fam == "hybrid":
        return 4 * lm.n_groups + 2 * cfg.num_layers
    if fam == "ssm":
        return 8 * cfg.num_layers
    if fam == "vlm":
        return (4 * lm.n_groups * lm.self_per_group
                + (5 if mode == "prefill" else 4) * lm.n_groups)
    return ACT_PER_LAYER * cfg.num_layers


def family_extra(torch, cfg, b: int, s: int, seed: int):
    """Seeded image embeddings (vlm) or frames (audio) on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.family == "vlm":
        return {"image_embeds": torch.randn(
            (b, cfg.num_image_tokens, cfg.d_model), generator=gen,
            device="cuda")}
    if cfg.family == "audio":
        return {"frames": torch.randn((b, s, cfg.d_model), generator=gen,
                                      device="cuda")}
    return None


def family_model(torch, LM, QuantConfig, cfg, seed: int):
    params = LM(cfg, QuantConfig()).init(seed=seed, device="cuda")
    for cb in params.get("cross_blocks", []):
        cb["gate"].fill_(FAMILY_GATE)
    torch.cuda.synchronize()
    return params


def family_kernels_vs_ref(torch, LM, QuantConfig, cfg, tag: str):
    """At 2 layers (one group for hybrid and vlm) of ``cfg``'s width, the
    kernel path against ``impl="ref"`` on the card: the same logits
    (error 0) and tokens (agreement 1.0000) over ``GEN_STEPS`` greedy
    steps; for the encoder, ``train_logits`` error 0."""
    small = dataclasses.replace(cfg, num_layers=2, **(
        {"attn_period": 2} if cfg.family == "hybrid" else
        {"cross_attn_period": 2} if cfg.family == "vlm" else {}))
    params = family_model(torch, LM, QuantConfig, small, 7)
    tokens = gen_tokens(torch, np, small.vocab_size, GEN_BATCH, GEN_PROMPT, 8)
    extra = family_extra(torch, small, GEN_BATCH, GEN_PROMPT, 9)
    if not small.has_decode:
        with torch.no_grad():
            got, want = (LM(small, QuantConfig(impl=i)).train_logits(
                params, tokens, extra)[0] for i in ("cuda", "ref"))
        err = float((got - want).abs().max())
        say(f"{tag} 2 layers: train_logits, kernels against impl='ref': max "
            f"err {err:.4g} over {tuple(got.shape)}")
        if err != 0.0:
            fail(f"{tag}: the kernel path must equal the plain one ({err})")
        return
    got, want = (generate(torch, LM, QuantConfig, small, params,
                          {"impl": i}, tokens, GEN_STEPS, extra)
                 for i in ("cuda", "ref"))
    err = float((got[0] - want[0]).abs().max())
    agree = float((got[1] == want[1]).float().mean())
    say(f"{tag} 2 layers: kernels against impl='ref': logits max err "
        f"{err:.4g} over {tuple(got[0].shape)}; greedy agreement "
        f"{agree:.4f} over {GEN_STEPS} steps")
    if err != 0.0 or agree != 1.0:
        fail(f"{tag}: the kernel path must equal the plain one (err {err}, "
             f"agreement {agree})")


def phase_families(torch, np, mods, KERNELS, get_config, rows, smi) -> dict:
    """The other families through ``LM`` on the card (``FAMILY_RUNS``):
    Zamba2-2.7B and RWKV6-1.6B at full width and depth and
    Llama-3.2-Vision-90B at full width and 10 of 100 layers, each
    ``prefill`` of 8 × 512 tokens into a 1,024-slot int4 cache then 32
    greedy decode steps; HuBERT-XLarge's 48-layer encoder over 8 × 512
    frames (``train_logits``). Every run: the launch counts set to 0
    before and read after it (the fused act-quant per layer kind and
    forward, K10 once per attention layer a decode step, none on RWKV or
    the encoder, the GEMMs, K1/K2 alone never), finite logits, times and
    peak memory. Then each family at 2 layers, kernels against
    ``impl="ref"``. → the Zamba2 run's launches."""
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    out = {}
    for arch, depth, what in FAMILY_RUNS:
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        cut = (f" ({depth} of {get_config(arch).num_layers} layers)"
               if depth is not None else f" ({cfg.num_layers} layers)")
        tag = f"[families] {cfg.name}{cut}"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = family_model(torch, LM, QuantConfig, cfg, 0)
        say(f"{tag}: random W4 weights made in {time.perf_counter() - t0:.1f}"
            f" s, {tree_bytes(params) / 1e9:.3f} GB")
        lm = LM(cfg, QuantConfig())
        tokens = gen_tokens(torch, np, cfg.vocab_size, GEN_BATCH, GEN_PROMPT,
                            3)
        extra = family_extra(torch, cfg, GEN_BATCH, GEN_PROMPT, 4)
        for kern in KERNELS.values():
            kern.launches = 0
        if what == "encode":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, _ = lm.train_logits(params, tokens, extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {n: k.launches for n, k in KERNELS.items()}
            want = {"act_quant_w4ax": family_act_quant(cfg, lm, "train"),
                    "kv4_decode_attention": 0}
            say(f"{tag}: train_logits over {GEN_BATCH} × {GEN_PROMPT} frames"
                f" in {wall * 1e3:.2f} ms; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")
        else:
            logits, toks, prefill_s, step_s, _ = generate(
                torch, LM, QuantConfig, cfg, params, {}, tokens, GEN_STEPS,
                extra)
            launches = {n: k.launches for n, k in KERNELS.items()}
            attn = (lm.n_groups if cfg.family == "hybrid" else
                    lm.n_groups * lm.self_per_group if cfg.family == "vlm"
                    else 0)
            want = {"kv4_decode_attention": GEN_STEPS * attn,
                    "act_quant_w4ax": family_act_quant(cfg, lm, "prefill")
                    + GEN_STEPS * family_act_quant(cfg, lm, "decode")}
            new = GEN_BATCH * GEN_STEPS
            say(f"{tag}: prefill {GEN_BATCH} × {GEN_PROMPT} tokens in "
                f"{prefill_s * 1e3:.2f} ms; {GEN_STEPS} decode steps, median "
                f"{statistics.median(step_s) * 1e3:.2f} ms, "
                f"{new / sum(step_s):.2f} decode tok/s; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")
            say(f"{tag} first row's tokens {toks[0].tolist()}")
        want.update({"act_quant_int4": 0, "act_quant_int8": 0})
        if not torch.isfinite(logits).all():
            fail(f"{tag}: non-finite logits")
        for name, n in want.items():
            if launches[name] != n:
                fail(f"{tag}: {name} launched {launches[name]} times, not {n}")
        for name in SPLIT[1:]:
            if launches[name] <= 0:
                fail(f"{tag}: {name} was never launched")
        for name, n in launches.items():
            if n and name not in want and name not in SPLIT:
                fail(f"{tag}: {name} launched {n} times off the model's path")
        say(f"{tag} launches {json.dumps(launches)}")
        out[arch] = launches
        del params, logits
        family_kernels_vs_ref(torch, LM, QuantConfig, cfg, tag)
        say(f"[time] families {arch}: {time.perf_counter() - t_arch:.1f} s")
    if "D=80" in rows.get("kv4_decode_attention", {}):
        rows["kv4_decode_attention"]["D=80"]["launches"] = out[
            "zamba2_2p7b"]["kv4_decode_attention"]
    return out["zamba2_2p7b"]


FAMPROF_STEPS = 8         # timed decode steps a model (after 3 warm-up)


def dispatch_count(torch, fn):
    """(aten ops dispatched, bytes of the f64 tensors they return) in one
    call of ``fn``: the host's op count and the f64 traffic of a step."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    seen = [0, 0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            seen[0] += 1
            seen[1] += sum(t.numel() * 8 for t in tree_leaves(out)
                           if isinstance(t, torch.Tensor)
                           and t.dtype == torch.float64)
            return out

    with Count():
        fn()
    torch.cuda.synchronize()
    return seen[0], seen[1]


def phase_famprof(torch, np, mods, get_config, smi):
    """A decode step of each decoding family of ``FAMILY_RUNS`` broken
    down (module docstring, ``--phases famprof``); nothing checked."""
    from torch.profiler import ProfilerActivity, profile
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    for arch, depth, what in FAMILY_RUNS:
        if what != "generate":
            continue
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        tag = f"[famprof] {cfg.name} ({cfg.num_layers} layers)"
        gc.collect()
        torch.cuda.empty_cache()
        params = family_model(torch, LM, QuantConfig, cfg, 0)
        lm = LM(cfg, QuantConfig())
        tokens = gen_tokens(torch, np, cfg.vocab_size, GEN_BATCH, GEN_PROMPT,
                            3)
        extra = family_extra(torch, cfg, GEN_BATCH, GEN_PROMPT, 4)
        cache = lm.init_cache(GEN_BATCH, GEN_MAX_LEN, device="cuda")
        logits, state = lm.prefill(params, tokens, cache, extra)
        tok = logits[:, -1].argmax(-1)[:, None]
        box = [state]

        def step():
            box[0] = lm.decode(params, tok, box[0])[1]

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        times = []
        for _ in range(FAMPROF_STEPS):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        n_ops, f64 = dispatch_count(torch, step)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        say(f"{tag}: median decode step {statistics.median(times) * 1e3:.2f} "
            f"ms over {FAMPROF_STEPS} (min {min(times) * 1e3:.2f}); "
            f"{n_ops} aten ops a step; f64 tensors written "
            f"{f64 / 1e6:.3f} MB a step | {smi}")
        say(f"{tag} profile of 3 steps:\n"
            + profile_table(torch, prof, wall, 3))
        del params, logits, state, box


# ------------------------------------------------------------------ train

TRAIN_DEPTH = 8          # of Llama-3-8B's 32 layers on one card: f32
#                          params, gradients and both AdamW moments take
#                          16 B a parameter, 128.5 GB at full depth, 44.7 GB
#                          at 8 layers
TRAIN_BATCH, TRAIN_SEQ, TRAIN_CHUNK, TRAIN_STEPS = 8, 1024, 512, 2
TRAIN_DEEP_STEPS = 6     # (a) at TRAIN_DEPTH: a warm-up and 5 timed steps
TRAIN_EXACT_DEPTH = 2    # the 1 × 1 mesh against make_train_step, and the
#                          four-card meshes against serial_train
TRAIN_MESHES = ((2, 2), (1, 4), (4, 1))   # (i) at Llama-3-8B width
TRAIN_MOE_MESH = (1, 4)                   # (i) at Moonlight width
# (ii): a warm-up and 5 timed steps, the checkpoint after them, then one
# profiled step
TRAIN_FULL_MESH, TRAIN_FULL_STEPS, TRAIN_CKPT_STEP = (2, 2), 7, 6
TRAIN_RESTORE_MESH = (1, 4)                                         # (iii)
TRAIN_COMM_REPS = 10     # timed calls of each collective in (ii)
TRAIN_FAMILIES = ("llama3_8b", "moonshot_v1_16b_a3b", "zamba2_2p7b",
                  "rwkv6_1p6b", "llama3p2_vision_90b", "hubert_xlarge")
TRAIN_SMOKE = (2, 24, 16)     # batch, tokens, loss chunk (two, one padded)
TRAIN_LR = 1e-3               # the card-against-CPU step's
# card against CPU: loss, grad norm; each gradient leaf (through AdamW's
# first moment, m = 0.1·g) to its max: a projection's to 2e-2, a
# per-channel leaf's (a sum over every position of bf16 terms that mostly
# cancel) to 0.15, the VLM's 0-d gate to 0.5; the whole tree's L2 to 2e-2
# (the bounds the CPU tests hold the port to the reference with:
# ``tests/test_torch_train_step.py``); the params moved by ~lr·sign(g)
# at a first step: max 2·lr apart, mean 0.05·lr
TRAIN_TOL = {"loss": 1e-3, "grad_norm": 1e-2, "matrix": 2e-2,
             "channel": 0.15, "gate": 0.5, "l2": 2e-2, "p_mean": 0.05}
TRAIN_CLI = ("--arch", "llama3_8b", "--smoke", "--steps", "8",
             "--ckpt-every", "4", "--log-every", "1")
TRAIN_METRICS = ("loss", "ce", "aux", "grad_norm", "lr")


def leaf_digest(torch, t) -> tuple:
    """An exact digest of a tensor's bits, on its device: the sums, mod
    2⁶⁴ (integer sums do not depend on their order), of its 32-bit (or
    16-bit) words and of each word times a position weight."""
    flat = t.detach().reshape(-1)
    w = {4: torch.int32, 2: torch.int16, 1: torch.int8}[flat.element_size()]
    bits = flat.contiguous().view(w).long()
    pos = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return (int(bits.sum()), int((bits * pos).sum()), tuple(t.shape))


def state_digests(torch, state) -> list:
    from repro_torch.training.checkpoint import flatten
    return [(p, leaf_digest(torch, t)) for p, t in flatten(state)]


def train_mesh_run(mesh, arch: str, depth: int, steps: int, batch: int,
                   seq: int, timed: bool = False, total: int = 0,
                   device=None) -> dict:
    """``steps`` train steps of ``arch`` at full width and ``depth``
    layers on this rank of ``mesh`` (None: ``make_train_step`` on one
    device): ``init_fp(0)``'s shards, the launcher's stream of ``batch``
    × ``seq`` tokens, AdamW at lr 3e-4 with weight decay 0.1 and a cosine
    schedule (warm-up 1, over ``total`` steps, default ``steps``) on the
    mesh's device (else ``device``) → each step's metrics (f32 bits) and
    ms, the
    digests of every param and both moments, the peak memory. The same
    function runs in a spawned rank and in ``serial_train``'s threads."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train_loop import make_train_step
    dev = mesh.device if mesh is not None else torch.device(device)
    cfg = dataclasses.replace(get_config(arch), num_layers=depth)
    lm = LM(cfg)
    specs = lm.train_specs(mesh) if mesh is not None else None
    params = lm.init_fp(seed=0, device=dev, mesh=mesh)
    state = OPT.adamw_init(params)
    step_fn = make_train_step(lm, OPT.AdamWConfig(
        lr=3e-4, weight_decay=0.1,
        schedule=OPT.cosine_schedule(1, total or steps)),
        loss_chunk=TRAIN_CHUNK, mesh=mesh, specs=specs)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq, global_batch=batch))
    metrics, times = [], []
    for step in range(steps):
        b = data.batch_for_step(step, dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, b)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        metrics.append(torch.stack([m[k].float() for k in TRAIN_METRICS])
                       .view(torch.int32).tolist())
    out = {"metrics": metrics, "ms": [t * 1e3 for t in times],
           "digests": state_digests(torch, (params, state))}
    if timed:
        out.update(params=params, state=state, step_fn=step_fn, data=data,
                   lm=lm, specs=specs)
    return out


def f32s(bits) -> list:
    return np.array(bits, np.int32).view(np.float32).tolist()


def train_one_card_rank(rank: int, world: int, device) -> dict:
    """The default train (a), one rank of a real NCCL process group: at
    ``TRAIN_EXACT_DEPTH`` layers the 1 × 1 mesh and
    ``make_train_step``, ``TRAIN_STEPS`` steps each (their digests and
    metrics); then at ``TRAIN_DEPTH`` layers ``TRAIN_DEEP_STEPS`` steps through
    the mesh, the port's launch counts set to 0 just before and read just
    after, and one more step under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.training import optimizer as OPT
    mesh = make_local_mesh(1, 1)
    out = {}
    out["s"] = {}
    for name, m in (("mesh", mesh), ("plain", None)):
        t0 = time.perf_counter()
        out[name] = train_mesh_run(m, "llama3_8b", TRAIN_EXACT_DEPTH,
                                   TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                                   device=device)
        gc.collect()
        torch.cuda.empty_cache()
        out["s"][name] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for k in ops.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    run = train_mesh_run(mesh, "llama3_8b", TRAIN_DEPTH, TRAIN_DEEP_STEPS,
                         TRAIN_BATCH, TRAIN_SEQ, timed=True)
    out["launches"] = {n: k.launches for n, k in ops.KERNELS.items()}
    out["run_s"] = time.perf_counter() - t0
    b = run["data"].batch_for_step(TRAIN_DEEP_STEPS, device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = run["step_fn"](run["params"], run["state"], b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["deep"] = {
        "metrics": run["metrics"], "ms": run["ms"],
        "profiled_loss": float(m["loss"]), "profiled_ms": wall * 1e3,
        "peak": torch.cuda.max_memory_allocated(),
        "params": sum(p.numel() for p in OPT.tree_leaves(run["params"])),
        "calls": sum(e.count for e in prof.key_averages()
                     if e.key.startswith(("cudaLaunchKernel",
                                          "cuLaunchKernel"))),
        "table": profile_table(torch, prof, wall, 1),
        "kinds": train_kinds(torch, prof)}
    out["s"]["deep"] = time.perf_counter() - t0
    return out


def train_one_card(torch, KERNELS, smi) -> dict:
    """(a) on any card count: :func:`train_one_card_rank` in this process
    as rank 0 of a one-rank NCCL process group (its own store, destroyed
    after; a spawned rank would pay a new process and CUDA context, ~20
    s on an H100); the 1 × 1 mesh must equal ``make_train_step`` bit for
    bit (every step's metrics, every param and both moments), the 8-layer
    run's losses finite and falling, none of the port's kernels
    launched."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_rank
    tag = f"[train] llama-3-8b ({TRAIN_DEPTH} of 32 layers, 1 x 1 mesh)"
    tmp = tempfile.mkdtemp(prefix="train_nccl_")
    try:
        device = init_rank(0, 1, os.path.join(tmp, "store"), "cuda", 600.0)
        res = train_one_card_rank(0, 1, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = res["mesh"], res["plain"]
    same = a["metrics"] == b["metrics"] and a["digests"] == b["digests"]
    say(f"[train] llama-3-8b at full width, {TRAIN_EXACT_DEPTH} layers, "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: the "
        f"1 x 1 NCCL mesh against make_train_step: "
        + ("every step's metrics and every param and AdamW moment (" +
           f"{len(a['digests'])} leaves) bit for bit" if same else
           "DIFFERENT") + f"; losses {[f32s(x)[0] for x in a['metrics']]}"
        f"; seconds {json.dumps(res['s'])}")
    if not same:
        bad = [p for (p, x), (_, y) in zip(a["digests"], b["digests"])
               if x != y]
        fail(f"[train] the 1 x 1 mesh is not make_train_step: metrics "
             f"{a['metrics']} vs {b['metrics']}; leaves {bad[:8]}")
    d = res["deep"]
    losses = [f32s(x)[0] for x in d["metrics"]] + [d["profiled_loss"]]
    med = statistics.median(d["ms"][1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / med * 1e3
    for step, (x, ms) in enumerate(zip(d["metrics"], d["ms"])):
        loss, _, _, gnorm, lr = f32s(x)
        say(f"{tag} step {step}: loss {loss:.6f} grad norm {gnorm:.6f} lr "
            f"{lr:.3e} {ms:.2f} ms")
    say(f"{tag}: {d['params'] / 1e6:.1f} M f32 parameters; B = "
        f"{TRAIN_BATCH}, S = {TRAIN_SEQ}, loss chunks of {TRAIN_CHUNK}: "
        f"median step {med:.2f} ms over steps 1–{TRAIN_DEEP_STEPS - 1} (first "
        f"{d['ms'][0]:.2f} ms), {tok_s:.1f} tokens/s; peak memory "
        f"{d['peak'] / 2**30:.2f} GiB ({d['peak'] / 1e9:.2f} GB); "
        f"{d['calls']} kernel launch calls a step; the profiled step "
        f"{d['profiled_ms']:.2f} ms | {smi}")
    say(f"{tag} profile of one step:\n" + d["table"])
    say(f"{tag} device time by kind: {d['kinds']}")
    say(f"{tag} launches {json.dumps(res['launches'])}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{tag}: the loss did not fall ({losses})")
    if any(res["launches"].values()):
        fail(f"{tag}: a W4 kernel launched in fp training: "
             f"{res['launches']}")
    for k in KERNELS.values():
        k.launches = 0
    return {"median_step_ms": med, "tokens_per_s": tok_s,
            "peak_bytes": d["peak"], "launch_calls": d["calls"],
            "losses": losses}


def comm_times(torch, mesh, shapes: dict) -> dict:
    """Median CUDA-event ms (of ``TRAIN_COMM_REPS``) of the training
    mesh's collectives at these f32 shapes beside NCCL's own: the model
    seam (all-gather + rank-order sum) and ``all_reduce``; the FSDP
    gather (all-gather + ``cat``) and ``all_gather_into_tensor``; the
    FSDP gradient's all-to-all + rank-order sum and
    ``reduce_scatter_tensor``."""
    import torch.distributed as dist

    from repro_torch.parallel import mesh as PM
    from repro_torch.parallel import sharding as SH
    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(3)

    def med(fn):
        ts = []
        for _ in range(TRAIN_COMM_REPS + 2):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts[2:])

    seam = torch.randn(shapes["seam"], generator=g, device=dev)
    shard = torch.randn(shapes["shard"], generator=g, device=dev)
    grad = torch.randn((shapes["shard"][0] * mesh.data_size,
                        shapes["shard"][1]), generator=g, device=dev)
    out_full = torch.empty_like(grad)
    out_shard = torch.empty_like(shard)
    acc = seam.clone()
    return {
        "seam_ms": med(lambda: PM.reduce_partials(seam, mesh)),
        "all_reduce_ms": med(lambda: dist.all_reduce(acc, group=mesh.group)),
        "fsdp_gather_ms": med(lambda: torch.cat(PM.axis_gather(
            shard, mesh, "data"))),
        "all_gather_into_tensor_ms": med(lambda: dist.all_gather_into_tensor(
            out_full, shard, group=mesh.data_group)),
        "fsdp_grad_ms": med(lambda: SH._sum_scatter(grad, 0, mesh, "data")),
        "reduce_scatter_ms": med(lambda: dist.reduce_scatter_tensor(
            out_shard, grad, group=mesh.data_group)),
        "shapes": shapes}


def train_four_rank(rank: int, world: int, device, ckpt: str) -> dict:
    """One of four spawned ranks (NCCL) of the four-card train forms: (i)
    each of ``TRAIN_MESHES`` at Llama-3-8B width and ``TRAIN_MOE_MESH`` at
    Moonlight width, ``TRAIN_EXACT_DEPTH`` layers, ``TRAIN_STEPS`` steps
    (metrics and digests, for ``serial_train``); (ii) Llama-3-8B at all
    32 layers over ``TRAIN_FULL_MESH``, ``TRAIN_FULL_STEPS`` steps, the
    state saved to ``ckpt`` after step ``TRAIN_CKPT_STEP``, every
    replicated leaf's digest the same on every rank holding it, the
    collectives timed, the last step profiled on rank 0; (iii) that
    checkpoint restored over ``TRAIN_RESTORE_MESH``, every leaf gathered
    whole and compared with the saved array on rank 0."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.lm import LM
    from repro_torch.parallel import mesh as PM
    from repro_torch.parallel import sharding as SH
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import optimizer as OPT
    out = {"exact": {}}
    for arch, mshape in ([("llama3_8b", m) for m in TRAIN_MESHES]
                         + [("moonshot_v1_16b_a3b", TRAIN_MOE_MESH)]):
        mesh = make_local_mesh(*mshape)
        r = train_mesh_run(mesh, arch, TRAIN_EXACT_DEPTH, TRAIN_STEPS,
                           TRAIN_BATCH, TRAIN_SEQ)
        out["exact"][(arch, mshape)] = {"metrics": r["metrics"],
                                        "digests": r["digests"]}
        gc.collect()
        torch.cuda.empty_cache()
    # (ii) full depth
    mesh = make_local_mesh(*TRAIN_FULL_MESH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train_mesh_run(mesh, "llama3_8b", 32, TRAIN_CKPT_STEP,
                         TRAIN_BATCH, TRAIN_SEQ, timed=True,
                         total=TRAIN_FULL_STEPS)
    params, state, step_fn = run["params"], run["state"], run["step_fn"]
    specs = run["specs"]
    tree_specs = (specs, OPT.state_specs(specs))
    full = {"metrics": run["metrics"], "ms": run["ms"],
            "made_and_run_s": time.perf_counter() - t0}
    # the launcher's checkpoint (params and AdamW state: 16 B - 4 B of
    # gradients = 12 B a parameter) where the disk holds it, else the
    # params alone
    need = 12 * sum(p.numel() for p in OPT.tree_leaves(params)) * mesh.world
    full["free_bytes"] = shutil.disk_usage(ckpt).free
    full["saved"] = ("params and AdamW state"
                     if full["free_bytes"] > 1.1 * need else "params")
    saved = (params, state) if full["saved"] != "params" else params
    t0 = time.perf_counter()
    CKPT.save(ckpt, TRAIN_CKPT_STEP, saved,
              mesh, tree_specs if full["saved"] != "params" else specs)
    full["save_s"] = time.perf_counter() - t0
    del saved
    dev = mesh.device
    for step in range(TRAIN_CKPT_STEP, TRAIN_FULL_STEPS):
        b = run["data"].batch_for_step(step, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = None
        if step == TRAIN_FULL_STEPS - 1 and rank == 0:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                params, state, m = step_fn(params, state, b)
                torch.cuda.synchronize()
        else:
            params, state, m = step_fn(params, state, b)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        full["metrics"].append(torch.stack(
            [m[k].float() for k in TRAIN_METRICS]).view(torch.int32).tolist())
        full["ms"].append(wall * 1e3)
        if prof is not None:
            full["table"] = profile_table(torch, prof, wall, 1)
            full["kinds"] = train_kinds(torch, prof)
    full["peak"] = torch.cuda.max_memory_allocated()
    # every rank holding a leaf's shard holds the same bits
    dig = torch.tensor([[d[0], d[1]] for _, d in
                        state_digests(torch, (params, state))],
                       dtype=torch.int64, device=dev)
    got = PM.axis_gather(dig, mesh, "world")
    bad = []
    for i, spec in enumerate(CKPT.flatten_specs((params, state), tree_specs)):
        for r in range(mesh.world):
            d, m_ = divmod(r, mesh.size)
            owner = ((d if "data" in spec else 0) * mesh.size
                     + (m_ if "model" in spec else 0))
            if not torch.equal(got[r][i], got[owner][i]):
                bad.append((i, r))
    full["replicated_bad"] = bad
    full["leaves"] = len(dig)
    del params, state, step_fn, run
    gc.collect()
    torch.cuda.empty_cache()
    full["comm"] = comm_times(torch, mesh, {"seam": (4 * TRAIN_SEQ, 4096),
                                            "shard": (2048, 7168)})
    out["full"] = full
    # (iii) the step-2 checkpoint over another mesh
    t0 = time.perf_counter()
    rmesh = make_local_mesh(*TRAIN_RESTORE_MESH)
    lm = LM(dataclasses.replace(get_config("llama3_8b"), num_layers=32))
    rspecs = lm.train_specs(rmesh)
    meta = lm.init_fp(device="meta")
    rtree_specs = (rspecs, OPT.state_specs(rspecs))
    full_tree = (meta, OPT.adamw_init(meta))
    if full["saved"] == "params":
        rtree_specs, full_tree = rspecs, meta
    template = CKPT._unflatten(full_tree, [
        torch.empty(SH.shard_shape(t.shape, sp, rmesh), dtype=t.dtype,
                    device="meta")
        for (_, t), sp in zip(CKPT.flatten(full_tree),
                              CKPT.flatten_specs(full_tree, rtree_specs))])
    tree, step = CKPT.restore(ckpt, template, device=dev,
                              shardings=rtree_specs, mesh=rmesh)
    restored = {"step": step, "read_s": time.perf_counter() - t0,
                "leaves": 0, "differ": []}
    path = os.path.join(ckpt, f"step_{step:08d}")
    for i, ((p, t), sp) in enumerate(zip(
            CKPT.flatten(tree), CKPT.flatten_specs(tree, rtree_specs))):
        whole = SH.unshard(t, sp, rmesh)
        if rank == 0:
            saved = torch.from_numpy(np.array(np.load(
                os.path.join(path, f"arr_{i:05d}.npy"), mmap_mode="r")))
            saved = saved.to(dev)
            ok = (saved.shape == whole.shape and saved.dtype == whole.dtype
                  and torch.equal(saved.view(torch.int32) if
                                  saved.dtype == torch.float32 else saved,
                                  whole.view(torch.int32) if
                                  whole.dtype == torch.float32 else whole))
            if not ok:
                restored["differ"].append(p)
            restored["leaves"] += 1
        del whole
    restored["s"] = time.perf_counter() - t0
    out["restore"] = restored
    return out


def train_four_card(torch, smi) -> dict:
    """The four-card train forms (``--phases train`` with four cards;
    else "not run"): :func:`train_four_rank` on four spawned ranks, then
    (i) each exactness run again as ``serial_train``'s threads on card 0,
    bit for bit; (ii), (iii) checked as its docstring says; (iv) the
    launcher with ``--data 2 --model 2`` resumed from its own
    checkpoint."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import spawn
    from repro_torch.parallel.mesh import serial_train
    cards = torch.cuda.device_count()
    if cards < 4:
        say(f"[train] four-card forms (i)–(iv): not run ({cards} visible "
            f"card(s))")
        return {}
    # the cards' interconnect, beside the collectives' times in (ii)
    try:
        topo = subprocess.run(["nvidia-smi", "topo", "-m"],
                              capture_output=True, text=True, timeout=60)
        topo = (topo.stdout.rstrip() if not topo.returncode else
                f"not read: exit {topo.returncode}: {topo.stderr.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        topo = f"not read: {e}"
    say(f"[train] interconnect (nvidia-smi topo -m):\n{topo}")
    root = tempfile.mkdtemp(prefix="train_ckpt_", dir=HERE / "build")
    t0 = time.perf_counter()
    try:
        res = spawn(train_four_rank, 4, (root,), device_type="cuda",
                    timeout_s=1800.0)
    except (RuntimeError, TimeoutError) as e:
        shutil.rmtree(root, ignore_errors=True)
        fail(f"[train] four ranks: {e}")
    shutil.rmtree(root, ignore_errors=True)
    say(f"[time] train four ranks: {time.perf_counter() - t0:.1f} s")
    # (i)
    for (arch, mshape), r0 in res[0]["exact"].items():
        t0 = time.perf_counter()
        emu = serial_train(train_mesh_run, *mshape, "cuda:0",
                           (arch, TRAIN_EXACT_DEPTH, TRAIN_STEPS,
                            TRAIN_BATCH, TRAIN_SEQ), timeout_s=900.0)
        bad = [r for r in range(4)
               if res[r]["exact"][(arch, mshape)]["metrics"]
               != emu[r]["metrics"]
               or res[r]["exact"][(arch, mshape)]["digests"]
               != emu[r]["digests"]]
        say(f"[train] (i) {arch} at full width, {TRAIN_EXACT_DEPTH} layers, "
            f"{mshape[0]} x {mshape[1]} over 4 cards against serial_train on "
            f"one card ({time.perf_counter() - t0:.1f} s): "
            + ("every rank's metrics and all of its "
               f"{len(r0['digests'])} leaves bit for bit" if not bad
               else f"ranks {bad} DIFFER")
            + f"; losses {[f32s(x)[0] for x in r0['metrics']]}")
        if bad:
            fail(f"[train] (i) {arch} {mshape}: ranks {bad} are not "
                 f"serial_train's")
        gc.collect()
        torch.cuda.empty_cache()
    # (ii)
    f0 = res[0]["full"]
    losses = [f32s(x)[0] for x in f0["metrics"]]
    med = statistics.median(f0["ms"][1:TRAIN_CKPT_STEP])
    tag = "[train] (ii) llama-3-8b, 32 layers, 2 x 2 over 4 cards"
    for step, (x, ms) in enumerate(zip(f0["metrics"], f0["ms"])):
        loss, _, _, gnorm, lr = f32s(x)
        say(f"{tag} step {step}: loss {loss:.6f} grad norm {gnorm:.6f} lr "
            f"{lr:.3e} {ms:.2f} ms" + (" (profiled)" if step ==
                                       TRAIN_FULL_STEPS - 1 else ""))
    peaks = [r["full"]["peak"] / 1e9 for r in res]
    say(f"{tag}: B = {TRAIN_BATCH}, S = {TRAIN_SEQ}: median step "
        f"{med:.2f} ms (steps 1–{TRAIN_CKPT_STEP - 1}, before the "
        f"checkpoint), "
        f"{TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.1f} tokens/s; peak memory "
        f"per card {[round(p, 2) for p in peaks]} GB; weights made and "
        f"{TRAIN_CKPT_STEP} steps {f0['made_and_run_s']:.1f} s; checkpoint "
        f"of step {TRAIN_CKPT_STEP} ({f0['saved']}; "
        f"{f0['free_bytes'] / 1e9:.1f} GB free on its disk) written in "
        f"{f0['save_s']:.1f} s | {smi}")
    say(f"{tag} collectives, rank 0, f32, median ms: "
        f"{json.dumps(f0['comm'])}")
    say(f"{tag} profile of step {TRAIN_FULL_STEPS - 1} on rank 0:\n"
        + f0.get("table", "none"))
    say(f"{tag} device time by kind: {f0.get('kinds')}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: non-finite loss {losses}")
    if any(r["full"]["replicated_bad"] for r in res):
        fail(f"{tag}: replicated leaves differ across ranks: "
             f"{[r['full']['replicated_bad'][:4] for r in res]}")
    say(f"{tag}: every replicated leaf ({f0['leaves']} leaves a rank) "
        f"identical on the ranks that hold it")
    if max(peaks) >= 80:
        fail(f"{tag}: peak memory {peaks} GB")
    # (iii)
    r3 = res[0]["restore"]
    say(f"[train] (iii) step {r3['step']} of (ii) restored over "
        f"{TRAIN_RESTORE_MESH[0]} x {TRAIN_RESTORE_MESH[1]}: "
        f"{r3['leaves']} leaves gathered whole, "
        + ("each the saved array bit for bit" if not r3["differ"]
           else f"DIFFERING {r3['differ'][:5]}")
        + f" (read {r3['read_s']:.1f} s, all {r3['s']:.1f} s)")
    if r3["differ"] or r3["step"] != TRAIN_CKPT_STEP or not r3["leaves"]:
        fail(f"[train] (iii) the restored checkpoint differs: {r3}")
    # (iv)
    train_launcher(("--data", "2", "--model", "2"))
    return {"median_step_ms": med, "peaks_gb": peaks, "losses": losses}


def train_kinds(torch, prof) -> str:
    """The profiled device time in bf16 GEMMs, f32 GEMMs (cuBLAS's f32
    kernels: the attention einsums, TF32 off) and everything else
    (elementwise, copies, reductions)."""
    ms = {"bf16 GEMM": 0.0, "f32 GEMM": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        name = e.key.lower()
        kind = ("other" if "gemm" not in name and "nvjet" not in name else
                "f32 GEMM" if "f32f32" in name or "sgemm" in name else
                "bf16 GEMM")
        ms[kind] += us / 1e3
    total = sum(ms.values())
    if not total:
        return "no device events in the trace"
    return ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f} %)"
                     for k, v in ms.items())


def _train_batch(torch, np, cfg, b: int, s: int, device: str) -> dict:
    """Seeded tokens and labels of the synthetic stream, a partial mask,
    and the family's frames or image embeddings (numpy's generator, so
    the card and the CPU get the same numbers)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    toks, labels = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b)).host_batch(0)
    mask = np.ones((b, s), np.float32)
    mask[1, s - 5:] = 0
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long(),
             "mask": torch.from_numpy(mask)}
    rng = np.random.default_rng(5)
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.normal(size=(
            b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(b, s, cfg.d_model)).astype(np.float32))
    return {k: v.to(device) for k, v in batch.items()}


def _train_leaf_tol(path, t) -> float:
    if t.dim() == 0:
        return TRAIN_TOL["gate"]
    if t.dim() == 1 or path.endswith("conv_w"):
        return TRAIN_TOL["channel"]
    return TRAIN_TOL["matrix"]


def train_card_vs_cpu(torch, np, LM, get_smoke_config):
    """(b) One train step of each family's smoke config on the card and
    on the CPU from the same fp params (the VLM's gates 0.5) and batch:
    loss, grad norm, AdamW's first moment leaf by leaf (``TRAIN_TOL``)
    and the updated params. The MoE router's (token, expert) choices of
    both are compared too (a bf16 near-tie routed otherwise moves the
    expert stacks' gradients far past the bounds)."""
    from repro_torch.layers import mlp as MLP
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.train_loop import make_train_step
    b, s, chunk = TRAIN_SMOKE
    route = MLP.moe_route
    for arch in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        cfg = get_smoke_config(arch)
        lm = LM(cfg)
        tag = f"[train] card vs CPU {arch} (smoke, {cfg.family})"
        opt = OPT.AdamWConfig(lr=TRAIN_LR)
        res = {}
        for dev in ("cpu", "cuda"):
            params = lm.init_fp(seed=0, device="cpu")
            for cb in params.get("cross_blocks", []):
                cb["gate"].fill_(FAMILY_GATE)
            params = OPT.tree_map(lambda t: t.to(dev), params)
            state = OPT.adamw_init(params)
            routes = []

            def rec(*args, **kw):
                out = route(*args, **kw)
                routes.append(out[2].cpu())
                return out
            MLP.moe_route = rec
            try:
                params, state, m = make_train_step(lm, opt, loss_chunk=chunk)(
                    params, state, _train_batch(torch, np, cfg, b, s, dev))
            finally:
                MLP.moe_route = route
            res[dev] = (OPT.tree_map(lambda t: t.cpu(), params),
                        OPT.tree_map(lambda t: t.cpu(), state),
                        {k: float(v) for k, v in m.items()}, routes)
        (pc, sc, mc, rc), (pg, sg, mg, rg) = res["cpu"], res["cuda"]
        agree = (float(torch.cat([(x == y).flatten() for x, y in zip(rc, rg)])
                       .float().mean()) if rc else None)
        errs = {k: abs(mg[k] - mc[k]) / abs(mc[k])
                for k in ("loss", "grad_norm")}
        worst, num, den, bad = {}, 0.0, 0.0, []
        want = dict(flatten(sc["m"]))
        for path, got in flatten(sg["m"]):
            w = want[path]
            scale = float(w.abs().max())
            d = float((got - w).abs().max())
            num += float(((got - w).double() ** 2).sum())
            den += float((w.double() ** 2).sum())
            tol = _train_leaf_tol(path, w)
            rel = d / scale if scale else d
            worst[tol] = max(worst.get(tol, (0.0, "")), (rel, path))
            if rel > tol or (scale == 0 and d != 0):
                bad.append((path, rel, tol))
        l2 = (num / den) ** 0.5
        p_cpu = dict(flatten(pc))
        dp = [(a - p_cpu[path]).abs() for path, a in flatten(pg)]
        dp_max = max(float(d.max()) for d in dp) / TRAIN_LR
        dp_mean = (sum(float(d.sum()) for d in dp)
                   / sum(d.numel() for d in dp) / TRAIN_LR)
        say(f"{tag}: loss {mg['loss']:.6f} / {mc['loss']:.6f} (rel "
            f"{errs['loss']:.2e}), grad norm {mg['grad_norm']:.6f} / "
            f"{mc['grad_norm']:.6f} (rel {errs['grad_norm']:.2e}), aux "
            f"{mg['aux']:.6e} / {mc['aux']:.6e}; m per class {worst}, L2 "
            f"{l2:.2e}; params max {dp_max:.3f}·lr, mean {dp_mean:.4f}·lr"
            + (f"; routing agreement {agree:.4f}" if agree is not None
               else "") + f" ({time.perf_counter() - t0:.1f} s)")
        if not all(math.isfinite(v) for v in (*mg.values(), *mc.values())):
            fail(f"{tag}: non-finite metrics {mg} {mc}")
        if errs["loss"] > TRAIN_TOL["loss"] or (
                errs["grad_norm"] > TRAIN_TOL["grad_norm"]):
            fail(f"{tag}: loss or grad norm apart ({errs})")
        if bad or l2 > TRAIN_TOL["l2"]:
            fail(f"{tag}: gradients apart: {bad[:5]} L2 {l2:.3e}"
                 + (f" (routing agreement {agree})" if agree is not None
                    else ""))
        if dp_max > 2 * (1 + 1e-3) or dp_mean > TRAIN_TOL["p_mean"]:
            fail(f"{tag}: params apart after the step (max {dp_max}·lr, "
                 f"mean {dp_mean}·lr)")


def train_launcher(extra=()):
    """(c) The training launcher in a subprocess on the card (with
    ``extra``: ``--data 2 --model 2``, four ranks): 8 steps of the smoke
    model with a checkpoint every 4, then a second process that resumes
    from step 4's checkpoint alone: its step 4–7 lines and its final
    checkpoint must equal the uninterrupted run's, bit for bit."""
    import tempfile
    pat = re.compile(r"^(step (\d+): loss=\S+ ce=\S+ gnorm=\S+) \(", re.M)
    cli = TRAIN_CLI + tuple(extra)
    tag = "train" + (" (iv)" if extra else "")
    with tempfile.TemporaryDirectory() as tmp:
        full, part = os.path.join(tmp, "full"), os.path.join(tmp, "part")
        a = _launch(cli + ("--ckpt-dir", full), 300,
                    "repro_torch.launch.train", tag)
        os.makedirs(part)
        os.rename(os.path.join(full, "step_00000004"),
                  os.path.join(part, "step_00000004"))
        b = _launch(cli + ("--ckpt-dir", part), 300,
                    "repro_torch.launch.train", tag)
        lines_a = {int(m[2]): m[1] for m in pat.finditer(a)}
        lines_b = {int(m[2]): m[1] for m in pat.finditer(b)}
        if "[resume] restored step 4" not in b or sorted(lines_b) != [
                4, 5, 6, 7] or sorted(lines_a) != list(range(8)):
            fail(f"{tag}: the resumed run's steps {sorted(lines_b)}, the "
                 f"uninterrupted run's {sorted(lines_a)}")
        if extra and "[mesh] (data=2, model=2) over 4 " not in a:
            fail(f"{tag}: no [mesh] line")
        if any(lines_b[k] != lines_a[k] for k in lines_b):
            fail(f"{tag}: the resumed run's step 4–7 lines differ")
        arrays = []
        for d in (full, part):
            step = os.path.join(d, "step_00000008")
            arrays.append([np.load(os.path.join(step, f))
                           for f in sorted(os.listdir(step))
                           if f.endswith(".npy")])
        same = [x.dtype == y.dtype and np.array_equal(x, y)
                for x, y in zip(*arrays)]
        if not same or not all(same) or len(arrays[0]) != len(arrays[1]):
            fail(f"{tag}: the final checkpoints differ in "
                 f"{same.count(False)} of {len(same)} arrays")
        say(f"[{tag}] resumed from step 4: steps 4–7 and the final "
            f"checkpoint's {len(same)} arrays equal the uninterrupted run's "
            f"bit for bit")


def phase_train(torch, np, mods, KERNELS, get_config, get_smoke_config,
                smi) -> dict:
    """The training slice on the card: (a) ``train_one_card`` (the 1 × 1
    NCCL mesh), (b) ``train_card_vs_cpu``, (c) ``train_launcher``, then
    with four cards ``train_four_card`` ((i)–(iv))."""
    LM = mods[1]
    t0 = time.perf_counter()
    out = train_one_card(torch, KERNELS, smi)
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[time] train (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_card_vs_cpu(torch, np, LM, get_smoke_config)
    say(f"[time] train (b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_launcher()
    say(f"[time] train (c): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    four = train_four_card(torch, smi)
    if four:
        out["four"] = four
        say(f"[time] train (i)–(iv): {time.perf_counter() - t0:.1f} s")
    return out


# the four projection shapes of Llama-3-8B: (name, K, N)
FMPQ_SHAPES = (("wq", 4096, 4096), ("wk/wv", 4096, 1024),
               ("w_up/w_gate", 4096, 14336), ("w_down", 14336, 4096))
FMPQ_CAL_ROWS = 512          # calibration rows per projection
FMPQ_OUTLIERS, FMPQ_MAG = 24, 50.0    # planted into every norm scale
FMPQ_DEPTH = 8               # layers of the fp comparison
FMPQ_DEPTHS = (1, 2, 4, FMPQ_DEPTH)
FMPQ_CAL = (4, 256)          # calibration prompts (batch, tokens)
# the quantized models held against the fp one, first logits: the planned
# and the unplanned W4Ax, and the unplanned weights with every activation
# block INT8 (W4A8) and with bf16 activations (W4A16), which part the
# weights' int4 error alone and A4's from the error FMPQ works on
FMPQ_AGAINST_FP = (("planned W4Ax", "planned", {}),
                   ("unplanned W4Ax", "plain", {}),
                   ("unplanned W4A8", "plain", {"int4_fraction": 0.0}),
                   ("unplanned W4A16", "plain", {"weight_only": True}))


def synthetic_llm_activations(np, rng, n_ch: int, n_outlier: int,
                              mag: float = 80.0):
    """Per-channel absmax of LLM-like activations
    (``benchmarks/fmpq_ratio.py``): log-normal, ``n_outlier`` channels
    ×``mag``."""
    absmax = rng.lognormal(0.0, 0.4, size=n_ch)
    absmax[rng.choice(n_ch, n_outlier, replace=False)] *= mag
    return absmax


def rel_l2(torch, y, exact) -> float:
    return float((y.double() - exact).norm() / exact.norm())


def fmpq_projections(torch, np, AQ, F, QL, Q, rows: dict, smi: str):
    """(a) Each Llama-3-8B projection shape, activations ``x[:, c] ~
    N(0, 1)·a_c/3`` with ``a`` from :func:`synthetic_llm_activations`
    (8–64 outlier channels ×80): a plan from the channel absmax of 512
    calibration rows, ``quantize_linear`` and ``qlinear_apply`` with the
    kernels ``torch.equal`` to ``impl="ref"`` (one fused act-quant a call)
    at M ∈ {8, 256}; the plan's INT4 fraction; FMPQ's error against
    float64 beside the unpermuted fraction path's at the same fraction,
    each against the float64 product of the path's own dequantized
    weights (the activation side, which the plan changes: FMPQ's must be
    below 0.8× the other's) and against the fp weights' (the weight error
    is common to both; printed); the gather + fused act-quant beside the
    fused act-quant alone (the K1 row's ``perm`` entries)."""
    rng = np.random.default_rng(7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, k, n in FMPQ_SHAPES:
        n_out = int(rng.integers(8, 64))
        scale = torch.from_numpy(synthetic_llm_activations(
            np, rng, k, n_out)).float().cuda() / 3

        def acts(m):
            return (torch.randn((m, k), generator=gen, device="cuda")
                    * scale).bfloat16()

        plan = F.plan_fmpq(F.collect_channel_stats(
            acts(FMPQ_CAL_ROWS).float()).double().cpu().numpy())
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        qp, spec = QL.quantize_linear(w, plan, impl="cuda")
        ref_spec = dataclasses.replace(spec, impl="ref")
        fqp, fspec = QL.quantize_linear_fraction(w, plan.int4_fraction,
                                                 impl="cuda")
        perm = qp["perm"]
        wd = Q.dequantize_weight_int4(qp["w_packed"], qp["w_scale"]).double()
        fwd = Q.dequantize_weight_int4(fqp["w_packed"],
                                       fqp["w_scale"]).double()
        for m in (8, 256):
            x = acts(m)
            before = AQ.act_quant_w4ax.launches
            y = QL.qlinear_apply(spec, qp, x, out_dtype=torch.float32)
            if AQ.act_quant_w4ax.launches != before + 1:
                fail(f"[fmpq] {name}: not one fused act-quant a call")
            err = check_exact(f"[fmpq] {name} M={m}", y, QL.qlinear_apply(
                ref_spec, qp, x, out_dtype=torch.float32), None)
            yf = QL.qlinear_apply(fspec, fqp, x, out_dtype=torch.float32)
            exact = x.double() @ w.double()
            act_f = rel_l2(torch, y, x[:, perm].double() @ wd)
            act_u = rel_l2(torch, yf, x.double() @ fwd)
            e2e_f, e2e_u = rel_l2(torch, y, exact), rel_l2(torch, yf, exact)
            say(f"[fmpq] {name} K={k} N={n} M={m}: {n_out} outlier "
                f"channels, plan INT4 fraction {plan.int4_fraction:.4f} "
                f"(k4 {plan.k4}); kernels = ref (err {err}); relative L2 "
                f"error, activation side: FMPQ {act_f:.5f}, unpermuted "
                f"{act_u:.5f} ({act_f / act_u:.3f}×); against the fp "
                f"weights: FMPQ {e2e_f:.5f}, unpermuted {e2e_u:.5f} "
                f"({e2e_f / e2e_u:.3f}×)")
            if not act_f < 0.8 * act_u:
                fail(f"[fmpq] {name} M={m}: FMPQ's error {act_f} is not "
                     f"below 0.8× the unpermuted path's {act_u}")
            if m != 256 and name != "w_down":
                continue
            alone = lambda: AQ.act_quant_w4ax(x, plan.k4)   # noqa: E731
            gathered = lambda: AQ.act_quant_w4ax(           # noqa: E731
                x.index_select(-1, perm), plan.k4)
            entry = {"shape": f"perm M={m} K={k} k4={plan.k4} bf16",
                     "ms": time_ms(torch, gathered),
                     "ms_100": time_ms_100(torch, gathered),
                     "without_perm_ms": time_ms(torch, alone),
                     "without_perm_ms_100": time_ms_100(torch, alone),
                     "plain_ms": time_ms(torch, lambda: AQ.act_quant_w4ax_ref(
                         x.index_select(-1, perm), plan.k4)),
                     "bound_ms": (act_bytes(m, k, plan.k4) + perm.nbytes)
                     / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
            if "act_quant_int4" in rows:     # K1's row: the fused op
                rows["act_quant_int4"][f"perm M={m} K={k}"] = entry
            say(f"[fmpq] gather + fused act-quant M={m} K={k}: "
                f"{entry['ms']:.6f} ms (100-call {entry['ms_100']:.6f}) "
                f"beside the fused act-quant alone {entry['without_perm_ms']:.6f}"
                f" ({entry['without_perm_ms_100']:.6f}) | {smi}")
        del w, wd, fwd, qp, fqp


def fmpq_model(torch, np, LM, F, C, ATT, MLP, cfg, seed: int, tokens):
    """Llama-3-8B's fp weights drawn block by block in ``LM.init``'s order
    from ``seed`` (the ``slice`` weights before quantization), every
    ``attn_norm`` and ``mlp_norm`` scale with ``FMPQ_OUTLIERS`` seeded
    channels set to ``FMPQ_MAG``; each block calibrated on ``tokens`` by
    an unrolled fp forward (its q/k/v input's and its up/gate input's
    channel absmax, as ``benchmarks/fmpq_ratio.py:collect_linear_stats``
    records them), planned, and packed with the plans (wo and w_down
    unplanned) and without; the fp blocks kept for the first
    ``FMPQ_DEPTH`` layers. → (planned params, unplanned params of the
    first ``FMPQ_DEPTH`` layers, fp params of those, the plans' INT4
    fractions)."""
    dev = "cuda"
    lm = LM(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    top = lm.init_top(gen, dev)
    qtop = {k: v for k, v in lm.quantize({**top, "blocks": []}).items()
            if k != "blocks"}
    rng = np.random.default_rng(seed)
    x = lm.embed(top, tokens)
    planned, plain, fp, fractions = [], [], [], []
    with torch.no_grad():
        for li in range(cfg.num_layers):
            blk = lm.init_block(gen, dev)
            for nm in ("attn_norm", "mlp_norm"):
                idx = torch.from_numpy(rng.choice(d, FMPQ_OUTLIERS,
                                                  replace=False)).to(dev)
                blk[nm]["scale"][idx] = FMPQ_MAG
            h = C.apply_norm(blk["attn_norm"], x, cfg.norm, cfg.norm_eps)
            qkv = F.collect_channel_stats(h.float()).double().cpu().numpy()
            x = x + ATT.attention_train(blk["attn"], cfg, h)
            h = C.apply_norm(blk["mlp_norm"], x, cfg.norm, cfg.norm_eps)
            ffn = F.collect_channel_stats(h.float()).double().cpu().numpy()
            x = x + MLP.mlp_apply(blk["mlp"], h)
            pq, pf = F.plan_fmpq(qkv), F.plan_fmpq(ffn)
            fractions.append((pq.int4_fraction, pf.int4_fraction))
            planned.append(lm.quantize_block(blk, {
                "wq": pq, "wk": pq, "wv": pq, "w_up": pf, "w_gate": pf}))
            if li < FMPQ_DEPTH:
                plain.append(lm.quantize_block(blk))
                fp.append(blk)
            del blk
    return ({**qtop, "blocks": planned}, {**qtop, "blocks": plain},
            {**top, "blocks": fp}, fractions)


def phase_fmpq(torch, np, mods, KERNELS, AQ, Q, cfg8b, params, rows,
               smi: str) -> dict:
    """(a) the planned projection at Llama-3-8B's shapes
    (:func:`fmpq_projections`); (b) the planned model
    (:func:`fmpq_model`): the plans' INT4 fractions; the first logits of
    the quantized models of ``FMPQ_AGAINST_FP`` against the fp model's
    at ``FMPQ_DEPTHS`` layers of full width; the planned model
    at full depth serving ``slice`` with ``slice``'s checks, its kernel
    launch calls a step beside the unplanned ``slice`` weights'; at 2
    layers the planned model served with the kernels and with
    ``impl="ref"``: agreement 1.0000, first logits error 0. → the
    planned ``slice`` run's launches."""
    from repro_torch.core import fmpq as F
    from repro_torch.core import qlinear as QL
    from repro_torch.layers import attention as ATT
    from repro_torch.layers import common as C
    from repro_torch.layers import mlp as MLP
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    t0 = time.perf_counter()

    def lap(part: str):
        say(f"[time] fmpq {part}: {time.perf_counter() - t0:.1f} s in")

    fmpq_projections(torch, np, AQ, F, QL, Q, rows, smi)
    lap("(a) projections")
    cal = gen_tokens(torch, np, cfg8b.vocab_size, *FMPQ_CAL, 3)
    planned, plain, fp, fractions = fmpq_model(
        torch, np, LM, F, C, ATT, MLP, cfg8b, 0, cal)
    fr = np.asarray(fractions)
    say(f"[fmpq] {cfg8b.num_layers} layers planned from {FMPQ_CAL[0]} × "
        f"{FMPQ_CAL[1]} calibration tokens ({FMPQ_OUTLIERS} channels of "
        f"every norm scale ×{FMPQ_MAG:g}): INT4 fraction q/k/v min "
        f"{fr[:, 0].min():.4f} mean {fr[:, 0].mean():.4f}, up/gate min "
        f"{fr[:, 1].min():.4f} mean {fr[:, 1].mean():.4f} (the dispatcher "
        f"serves K4 from int4_fraction 0.875)")
    lap("(b) calibration and plans")
    ev = gen_tokens(torch, np, cfg8b.vocab_size, 4, 128, 4)
    for depth in FMPQ_DEPTHS:
        cfg_d = dataclasses.replace(cfg8b, num_layers=depth)
        ref = LM(cfg_d).prefill({**fp, "blocks": fp["blocks"][:depth]}, ev,
                                LM(cfg_d).init_cache(4, 128, "cuda"))[0]
        for label, p, qc in FMPQ_AGAINST_FP:
            lm = LM(cfg_d, QuantConfig(**qc))
            p = planned if p == "planned" else plain
            got = lm.prefill({**p, "blocks": p["blocks"][:depth]}, ev,
                             lm.init_cache(4, 128, "cuda"))[0]
            err = float((got - ref).abs().max() / ref.abs().max())
            mean = float((got - ref).abs().mean() / ref.abs().mean())
            top1 = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
            say(f"[fmpq] {label}, {depth} of {cfg8b.num_layers} layers "
                f"at full width: first-logit error against the fp model "
                f"{err:.5f} of max|logit| (mean {mean:.5f}); top-1 "
                f"agreement {top1:.2f} over 4 prompts of 128 tokens")
    del fp, plain
    gc.collect()
    torch.cuda.empty_cache()
    lap("(b) against fp")
    launches = serve_llama(torch, np, mods, KERNELS, cfg8b, planned, "slice",
                           phase="fmpq")
    calls = {label: moe_launch_calls(torch, np, mods, cfg8b, p)
             for label, p in (("planned", planned), ("slice", params))}
    say(f"[fmpq] kernel launch calls a step (steps 5–6): planned "
        f"{calls['planned']:.1f}, the slice weights {calls['slice']:.1f} | "
        f"{smi}")
    lap("(b) planned slice")
    cfg2 = dataclasses.replace(cfg8b, num_layers=2)
    p2 = {**planned, "blocks": planned["blocks"][:2]}
    del planned
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg2.vocab_size, n).tolist()
               for n in (40, 7, 23, 64, 13, 29)]
    res = {}
    for impl in ("auto", "ref"):
        eng, first, _ = serve(torch, np, Engine, EngineConfig, QuantConfig,
                              cfg2, p2, impl, prompts, 16, EngineConfig(
                                  max_batch=8, num_pages=128, page_size=64,
                                  max_pages_per_seq=16,
                                  prefill_chunk_tokens=48, kv_range=4.0), {})
        res[impl] = (check_run(eng, len(prompts), 16, cfg2.vocab_size,
                               f"fmpq parity[{impl}]"), first)
    (tk, lk), (tr, lr) = res["auto"], res["ref"]
    err = float(np.abs(lk - lr).max())
    total = sum(len(v) for v in tr.values())
    agree = sum(a == b for i in tr for a, b in zip(tk[i], tr[i])) / total
    say(f"[fmpq] planned parity, 2 layers: first logits max err {err:.4g}; "
        f"greedy agreement {agree:.4f} over {total} tokens")
    if err != 0.0 or agree != 1.0:
        fail(f"[fmpq] planned parity: the kernel path must equal the plain "
             f"one (err {err}, agreement {agree})")
    lap("(b) parity")
    return launches


# ---------------------------------------------------- tensor parallelism

TP_SIZES = (1, 2, 4)       # the world sizes the tp phase runs, cards allowing
TP_SHARD = 4               # the per-shard shapes the kernels phase checks
# (model, projection, N, K) of one rank's shard at M = 4: wq/wk/w_up
# (and wv, w_gate) column slices, wo/w_down row slices (K3 and K4 see a
# K-slice, its INT4/INT8 split rounded per shard)
TP_GEMMS = (("8B", "wq", 1024, 4096), ("8B", "wk", 256, 4096),
            ("8B", "wo", 4096, 1024), ("8B", "w_up", 3584, 4096),
            ("8B", "w_down", 4096, 3584),
            ("70B", "wq", 2048, 8192), ("70B", "wk", 256, 8192),
            ("70B", "wo", 8192, 2048), ("70B", "w_up", 7168, 8192),
            ("70B", "w_down", 8192, 7168))
TP_HEADS = (("8B", 2, 4), ("70B", 2, 8))    # (model, local kv heads, G)
# the tp phase's runs on Llama-3-8B: (a) the token contract's config,
# (b) the default one
TP_RUNS = (("a", {"int4_fraction": 1.0}), ("b", {}))
TP_PROFILE = (5, 12)       # the steps whose kernel launch calls are counted
TP_SEAM = ((8, 4096), (256, 4096), (8, 8192), (256, 8192))   # (T, N)


def check_tp_kernels(torch, AQ, WK, Q, KVC, PA, cfg8b, rows: dict):
    """The kernels at one rank's shapes under ``TP_SHARD``-way tensor
    parallelism (``TP_GEMMS``, ``TP_HEADS``), against their plain
    versions: the fused act-quant (K1 + K2) byte for byte and K3, K4 bit
    for bit at M ∈ {8, 256}, K9 and K7 bit for bit at the local heads;
    each row parallel down projection's act-quant and GEMMs timed (entries
    ``TP4 <model> w_down`` of K1's, K2's, K3's and K4's rows, the
    attention kernels' under ``TP4 <model>``)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for model, proj, n, k in TP_GEMMS:
        nb = k // 128
        nb4 = int(round(0.875 * nb))
        k4 = nb4 * 128
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        wp, ws = Q.quantize_weight_int4(w, group_size=128)
        for m in (256, 8):
            x = act_input(torch, gen, m, k, k4)
            qa = AQ.act_quant_w4ax(x, k4)
            want = AQ.act_quant_w4ax_ref(x, k4)
            torch.cuda.synchronize()
            if not all(torch.equal(g, h) for g, h in zip(qa, want)):
                fail(f"act_quant_w4ax TP{TP_SHARD} {model} {proj} M={m} "
                     f"K={k} k4={k4}: not byte-exact")
            a4, s4, a8, s8 = qa
            pairs = (("w4a4_matmul", (a4, s4, wp[:k4 // 2], ws[:nb4])),
                     ("w4a8_matmul", (a8, s8, wp[k4 // 2:], ws[nb4:])))
            for name, args in pairs:
                if not torch.equal(getattr(WK, name)(*args),
                                   getattr(WK, name + "_ref")(*args)):
                    fail(f"{name} TP{TP_SHARD} {model} {proj} M={m} N={n} "
                         f"K={k}: not bit-exact")
            if proj == "w_down":
                key = f"TP{TP_SHARD} {model} w_down"
                times = {nm: gemm_times(torch, WK, Q, gen, nm, a)
                         for nm, a in pairs}
                if m == 256:
                    act = act_times(torch, AQ, x, k4)
                    for nm in ("act_quant_int4", "act_quant_int8"):
                        rows[nm][key] = dict(act)
                    for nm in times:
                        rows[nm][key] = times[nm]
                else:
                    for nm in times:
                        rows[nm][key]["decode"] = times[nm]
        say(f"[kernels] TP{TP_SHARD} {model} {proj} shard N={n} K={k} "
            f"({nb4}+{nb - nb4} blocks), M ∈ {{8, 256}}: act-quant "
            f"byte-exact, K3 and K4 exact")
    for model, hkv, g in TP_HEADS:
        check_attention(torch, gqa_cfg(cfg8b, hkv, g), KVC, PA, Q, rows,
                        f"TP{TP_SHARD} {model}")


def tp_cfg(get_config, arch: str, depth):
    cfg = get_config(arch)
    return cfg if depth is None else dataclasses.replace(cfg,
                                                         num_layers=depth)


def tp_prompts(vocab: int):
    """The ``slice`` workload's prompts (8 of 128–512 tokens, seed 0)."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, int(n)).tolist()
            for n in rng.integers(128, 513, 8)]


def tp_seam_times(torch, mesh) -> dict:
    """Per call, host wall time over 50 synchronized calls: the seam's
    all-gather and rank-order sum of f32 partials ``[T, N]`` and, as the
    library figure, NCCL's ``all_reduce`` of the same tensor."""
    import torch.distributed as dist
    from repro_torch.parallel.mesh import reduce_partials
    out = {}
    for t, n in TP_SEAM:
        y = torch.randn((t, n), device=mesh.device)
        for label, fn in (("seam_ms", lambda: reduce_partials(y, mesh)),
                          ("all_reduce_ms",
                           lambda: dist.all_reduce(y.clone(),
                                                   group=mesh.group))):
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            dist.barrier(group=mesh.host_group)
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            out.setdefault(f"T={t} N={n}", {})[label] = \
                (time.perf_counter() - t0) / 50 * 1e3
    return out


def tp_rank(rank: int, world: int, device, jobs) -> list:
    """One rank of the tp phase (a spawned process): :func:`tp_model` for
    each ``(arch, depth, runs)`` of ``jobs`` in turn, then the seam's
    times → what the parent reports."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(1, world)
    out = []
    for job in jobs:
        out.append(tp_model(torch, mesh, *job))
        gc.collect()
        torch.cuda.empty_cache()
    if world > 1:
        out[0]["seam"] = tp_seam_times(torch, mesh)
    return out


def tp_model(torch, mesh, arch: str, depth, runs) -> dict:
    """This rank's shard of the seeded weights made block by block, then
    each of ``runs`` (name, ``QuantConfig`` fields) on the ``slice``
    workload with the sanitizers on (every step the ranks' tokens and
    scheduler state must agree); run (b) again to count its kernel
    launch calls over ``TP_PROFILE`` (a run of its own, so the
    profiler's cost stays out of the times)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.lm import LM, QuantConfig
    from repro_torch.serving.engine import Engine, EngineConfig
    device, rank, world = mesh.device, mesh.model_rank, mesh.size
    cfg = tp_cfg(get_config, arch, depth)
    lm = LM(cfg)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = lm.init(seed=0, device=device, mesh=mesh)
    torch.cuda.synchronize()
    out = {"made_s": time.perf_counter() - t0, "layers": cfg.num_layers,
           "param_bytes": tree_bytes(params), "runs": {}}
    axes = lm.axes(params)
    prompts = tp_prompts(cfg.vocab_size)
    for name, quant_kw in runs:
        gc.collect()
        torch.cuda.reset_peak_memory_stats(device)
        for kern in ops.KERNELS.values():
            kern.launches = 0
        ecfg = EngineConfig(prefill_chunk_tokens=256, sanitize=True)
        t0 = time.perf_counter()
        eng, first, step_s = serve(
            torch, np, Engine, EngineConfig, QuantConfig, cfg, params,
            "auto", prompts, 32, ecfg, quant_kw, mesh=mesh, param_axes=axes)
        wall = time.perf_counter() - t0
        toks = check_run(eng, len(prompts), 32, cfg.vocab_size,
                         f"[tp] M={world} rank {rank} run {name}")
        if eng.sanitize_checks != eng.steps:
            fail(f"[tp] M={world} rank {rank}: {eng.sanitize_checks} "
                 f"sanitizer passes in {eng.steps} steps")
        out["runs"][name] = {
            "tokens": toks, "first": first, "steps": eng.steps,
            "forwards": eng.forward_calls, "wall": wall,
            "tok_s": eng.tokens_generated / wall,
            "median_step_ms": statistics.median(step_s) * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "launches": {n: k.launches for n, k in ops.KERNELS.items()},
            "launch_calls": None,
            "per_shard": eng.attn_work_items_per_shard,
            "work_items": eng.attn_work_items}
        del eng
        if name == "b":
            eng, _, _ = serve(
                torch, np, Engine, EngineConfig, QuantConfig, cfg, params,
                "auto", prompts, 32, ecfg, quant_kw, mesh=mesh,
                param_axes=axes, profile_steps=TP_PROFILE)
            out["runs"][name]["launch_calls"] = eng.smoke_launch_calls
            del eng
    del params
    return out


def tp_spawn(world: int, jobs) -> list:
    """:func:`tp_rank` on ``world`` new ranks → per job, every rank's
    result."""
    from repro_torch.launch.mesh import spawn
    try:
        res = spawn(tp_rank, world, (jobs,), device_type="cuda",
                    timeout_s=900.0)
    except (RuntimeError, TimeoutError, ValueError) as e:
        fail(f"[tp] M={world}: {e}")
    return [[r[j] for r in res] for j in range(len(jobs))]


def tp_check_ranks(res: list, label: str):
    """Every rank emitted the same tokens (the sanitizer also compared
    them after every step)."""
    for name in res[0]["runs"]:
        toks = [r["runs"][name]["tokens"] for r in res]
        if any(t != toks[0] for t in toks):
            fail(f"{label} run {name}: the ranks' tokens differ")


def agreement(a: dict, b: dict) -> float:
    total = sum(len(v) for v in a.values())
    return sum(x == y for i in a for x, y in zip(a[i], b[i])) / total


TP_SHALLOW = 2      # the depth of run (a2): (a) with its amplification cut


@contextlib.contextmanager
def serial_seams(m: int):
    """While open, the unsharded engine computes every row-parallel
    projection (wo, w_down) as ``m`` ranks' seams do: K-slices taken here
    by plain indexing of the whole weights, each a GEMM with f32 output,
    summed in rank order, the bias added once, rounded to bf16 once."""
    import torch
    from repro_torch.core import qlinear as QL
    from repro_torch.serving import engine as E

    def row_linear(p, x, quant, mesh):
        ks = x.shape[-1] // m
        acc = None
        for r in range(m):
            part = {"w_packed": p["w_packed"][r * ks // 2:(r + 1) * ks // 2],
                    "w_scale": p["w_scale"][r * ks // QL.BLOCK_K:
                                            (r + 1) * ks // QL.BLOCK_K]}
            y = QL.dispatch_qlinear(
                part, x[..., r * ks:(r + 1) * ks].to(torch.bfloat16)
                .contiguous(), quant, out_dtype=torch.float32)
            acc = y if acc is None else acc + y
        if "b" in p:
            acc = acc + p["b"].float()
        return acc.to(torch.bfloat16)

    saved = E._row_linear
    E._row_linear = row_linear
    try:
        yield
    finally:
        E._row_linear = saved


def phase_tp(torch, np, mods, cfg8b, params):
    """Tensor parallelism over the visible cards (``TP_SIZES``; a size the
    cards cannot give is named, not run). World size 1 runs through the
    real process group and seams and must equal the unsharded engine bit
    for bit on the ``slice`` workload (tokens and first logits). With
    more cards, each 8B run at M ranks must equal the unsharded engine
    under ``serial_seams(M)`` bit for bit, and on Llama-3-8B at full
    width and depth: (a) at
    ``int4_fraction=1.0`` token agreement with one device and the largest
    first-logit difference (and (a2), the same at ``TP_SHALLOW`` layers),
    (b) the default configuration's tokens/s, median step, peak memory
    per card and kernel launch calls per step per rank; then (c)
    Llama-3-70B at full width and depth over the largest mesh; each with
    the ranks' tokens identical at every step; the seam's times beside
    NCCL's ``all_reduce``; then the cli phase's first launcher call with
    ``--mesh`` over the largest mesh, whose counts must follow from the
    flags as on one card. → {world size: rank results of the 8B job}."""
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    cards = torch.cuda.device_count()
    sizes = [w for w in TP_SIZES if w <= cards]
    say(f"[tp] world sizes run: {sizes}; "
        + (f"not run: {[w for w in TP_SIZES if w > cards]} "
           f"({cards} visible card(s))" if len(sizes) < len(TP_SIZES)
           else "all"))
    runs = TP_RUNS if cards > 1 else TP_RUNS[1:]
    shallow = dataclasses.replace(cfg8b, num_layers=TP_SHALLOW)
    # the unsharded engine's runs that the meshes run — (b); with more
    # cards (a) and (a2) — plain (key 1), and for each larger world size M
    # the cards give under serial_seams(M) (key M), whose token agreement
    # with the plain runs and first-logit gap are printed
    one = {w: {} for w in sizes}
    for name, cfg, quant_kw in [(n, cfg8b, q) for n, q in runs] + (
            [("a2", shallow, TP_RUNS[0][1])] if max(sizes) > 1 else []):
        p = params if cfg is cfg8b else LM(cfg).init(seed=0, device="cuda")
        for world in sizes:
            with (serial_seams(world) if world > 1
                  else contextlib.nullcontext()):
                eng, first, _ = serve(
                    torch, np, Engine, EngineConfig, QuantConfig, cfg, p,
                    "auto", tp_prompts(cfg.vocab_size), 32,
                    EngineConfig(prefill_chunk_tokens=256), quant_kw)
            one[world][name] = (check_run(eng, 8, 32, cfg.vocab_size,
                                          f"[tp] unsharded run {name}"),
                                first)
            del eng
            if world > 1:
                (toks, first), (s_toks, s_first) = (one[1][name],
                                                    one[world][name])
                say(f"[tp] unsharded run {name} ({cfg.num_layers} layers) "
                    f"under serial_seams({world}) against the plain "
                    f"unsharded run: token agreement "
                    f"{agreement(toks, s_toks):.4f}, first-logit max |diff| "
                    f"{float(np.abs(s_first - first).max()):g} (max |logit| "
                    f"{float(np.abs(first).max()):g})")
        del p
    gc.collect()
    torch.cuda.empty_cache()
    results = {}
    for world in sizes:
        jobs = [("llama3_8b", None, runs)]
        if world > 1:
            jobs.append(("llama3_8b", TP_SHALLOW, (("a2", TP_RUNS[0][1]),)))
        if world == max(sizes) > 1:
            jobs.append(("llama3_70b", None, (("c", {}),)))
        out = tp_spawn(world, jobs)
        results[world] = res = out[0]
        for job, rs in zip(jobs, out):
            tp_check_ranks(rs, f"[tp] {job[0]} M={world}")
        for rs in out[:2]:
            for name in rs[0]["runs"]:
                tp_report(rs, world, name, one[1][name], one[world][name],
                          TP_PROFILE)
        if "seam" in res[0]:
            say(f"[tp] M={world} seam (all-gather + rank-order sum) vs NCCL "
                f"all_reduce, host ms per call, rank 0: "
                f"{json.dumps(res[0]['seam'])}")
        if len(out) == 3:
            rs = out[2]
            r0 = rs[0]["runs"]["c"]
            say(f"[tp] llama-3-70b M={world} run c (default configuration, "
                f"80 layers): {r0['steps']} steps, {r0['tok_s']:.2f} tok/s, "
                f"median step {r0['median_step_ms']:.2f} ms; peak memory per "
                f"card {[round(r['runs']['c']['peak_gb'], 2) for r in rs]} "
                f"GB; weights per card {rs[0]['param_bytes'] / 1e9:.2f} GB "
                f"made in {rs[0]['made_s']:.1f} s; ranks' tokens identical")
            say(f"[tp] llama-3-70b M={world} run c rank 0 launches "
                f"{json.dumps(r0['launches'])}")
    if max(sizes) > 1:       # the launcher's own ranks, the cli's counts
        phase_cli(("--mesh", f"1x{max(sizes)}"))
    return results


def tp_report(rs: list, world: int, name: str, one, serial, prof):
    """One run's line against the unsharded engine's (tokens, first
    logits), ``one`` plain and ``serial`` under ``serial_seams(world)``
    (at world size 1 the same run): it must be ``serial`` bit for bit."""
    r0 = rs[0]["runs"][name]
    toks, first = one
    gap = float(np.abs(r0["first"] - first).max())
    agree = agreement(toks, r0["tokens"])
    s_toks, s_first = serial
    if r0["tokens"] != s_toks or not np.array_equal(r0["first"], s_first):
        fail(f"[tp] M={world} run {name}: not bit for bit the unsharded "
             f"engine{' under serial_seams' if world > 1 else ''} (token "
             f"agreement {agreement(s_toks, r0['tokens']):.4f}, first-logit "
             f"gap {float(np.abs(r0['first'] - s_first).max()):g})")
    if world > 1:
        say(f"[tp] M={world} run {name}: tokens and first logits bit for "
            f"bit the unsharded engine under serial_seams({world})")
    calls = [r["runs"][name]["launch_calls"] for r in rs]
    say(f"[tp] llama-3-8b M={world} run {name} "
        f"({json.dumps(dict(TP_RUNS).get(name, dict(TP_RUNS)['a']))}, "
        f"{rs[0]['layers']} layers): token agreement with one device "
        f"{agree:.4f}, first-logit max |diff| {gap:g} (max |logit| "
        f"{float(np.abs(first).max()):g}); {r0['steps']} steps, "
        f"{r0['forwards']} forwards, {r0['tok_s']:.2f} tok/s, median step "
        f"{r0['median_step_ms']:.2f} ms; peak memory per card "
        f"{[round(r['runs'][name]['peak_gb'], 2) for r in rs]} GB; weights "
        f"per card {rs[0]['param_bytes'] / 1e9:.2f} GB made in "
        f"{rs[0]['made_s']:.1f} s; attention work items per rank "
        f"{r0['per_shard']} of {r0['work_items']}"
        + (f"; kernel launch calls per step per rank "
           f"{[c / (prof[1] - prof[0] + 1) for c in calls]} (steps "
           f"{prof[0]}–{prof[1]})" if calls[0] is not None else ""))
    say(f"[tp] M={world} run {name} rank 0 launches "
        f"{json.dumps(r0['launches'])}")


# the cli phase's launcher flags, and what they must lead to: 8 requests
# into a 6-deep waiting queue reject the last 2, every 4th submit (the 4th;
# the 8th is already rejected) is aborted after its first token, and the 5
# others finish with all 32 tokens (greedy decoding has no EOS)
CLI = ("--arch", "llama3_8b", "--schedule", "mixed", "--requests", "8",
       "--prompt-len", "512", "--max-new", "32", "--prefill-chunk", "256",
       "--shared-prefix", "128", "--abort-every", "4", "--max-waiting", "6")
CLI_EXPECT = {"failed": 0, "callback_errors": 0, "internal_errors": 0,
              "rejected": 2, "aborted": 1, "states": "aborted=1 failed=2 "
              "finished=5", "reasons": "aborted=1 queue_full=2",
              "tokens": ",".join(["32"] * 5)}
# the second call: the same flags, sampled at T = 0.8 from the top 40 with
# 3 drafts a decode row and the sanitizers on; the same counts follow
CLI_SPEC = ("--temperature", "0.8", "--top-k", "40", "--speculation", "3",
            "--sanitize")


# the third call: the same flags behind two replicas, replica 0 killed
# before its 6th engine step and promoted from its shipped artifacts
# (the group path serves every request: no abort, and 8 requests spread
# over two 6-deep queues are never rejected), each replica's pool sized
# to its 4 requests (96 pages of 32 keys, ~100 MB a snapshot)
CLI_GROUP = ("--replicas", "2", "--failover", "standby",
             "--kill-replica-at", "6", "--snapshot-every", "4",
             "--pages", "96")
CLI_GROUP_EXPECT = {
    "done": "8 requests, 256 tokens", "group": "replicas=2 "
    "failover=standby failovers=1 migrated=0", "health": "r0=promoted "
    "r1=live", "robust": "failed=0 timed_out=0 shed=0 rejected=0 "
    "internal_errors=0", "death": "replica 0 at engine step 5 (crash)",
    "states": "finished=8 | stop reasons: none | tokens of finished "
    "requests: " + ",".join(["32"] * 8)}


# the fourth call: the smoke configuration (head_dim 32) through the kernels
# alone (--impl cuda: a plain version anywhere on the path would raise)
CLI_SMOKE = ("--arch", "llama3_8b", "--smoke", "--impl", "cuda",
             "--requests", "4", "--max-new", "8", "--prompt-len", "32")
CLI_SMOKE_EXPECT = {
    "done": "4 requests, 32 tokens", "robust": "failed=0 timed_out=0 shed=0 "
    "rejected=0 callback_errors=0 internal_errors=0",
    "states": "finished=4 | stop reasons: none | tokens of finished "
    "requests: 8,8,8,8"}


def _launch(cli, timeout_s: float, module: str = "repro_torch.launch.serve",
            tag: str = "cli") -> str:
    """A launcher (``module``, default the serve launcher) in a
    subprocess with ``cli`` → what it printed (each line printed here
    too, after ``[tag]``); a non-zero exit fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    say(f"[{tag}] python -m {module} {' '.join(cli)}")
    try:
        out = subprocess.run(
            [sys.executable, "-m", module, *cli],
            cwd=HERE, env=env, capture_output=True, text=True,
            timeout=timeout_s)
    except subprocess.TimeoutExpired:
        fail(f"{tag}: the launcher did not finish in {timeout_s:.0f} s")
    for line in out.stdout.splitlines():
        say(f"[{tag}] {line}")
    if out.returncode:
        fail(f"{tag}: exit code {out.returncode}:\n{out.stderr[-4000:]}")
    return out.stdout


def phase_cli(extra=(), timeout_s: float = 600.0):
    """The serve launcher in a subprocess at full width and depth under
    the mixed schedule, with ``CLI`` and ``extra`` flags; its lines are
    printed, and the counts must follow from the flags (``CLI_EXPECT``;
    with ``--speculation``, its summary line with drafted = accepted +
    rolled back; with ``--sanitize``, a check every step)."""
    cli = CLI + tuple(extra)
    t0 = time.perf_counter()
    text = _launch(cli, timeout_s)
    robust = re.search(r"\[robust\] failed=(\d+) timed_out=\d+ shed=\d+ "
                       r"rejected=(\d+) callback_errors=(\d+) "
                       r"internal_errors=(\d+)", text)
    cache = re.search(r"\[cache\] .* aborted=(\d+)", text)
    states = re.search(r"^\[states\] (.*) \| stop reasons: (.*) \| tokens "
                       r"of finished requests: (.*)$", text, re.M)
    if not (robust and cache and states):
        fail("cli: summary lines missing")
    got = {"failed": int(robust[1]), "rejected": int(robust[2]),
           "callback_errors": int(robust[3]),
           "internal_errors": int(robust[4]), "aborted": int(cache[1]),
           "states": states[1], "reasons": states[2], "tokens": states[3]}
    if got != CLI_EXPECT:
        fail(f"cli: got {got}, expected {CLI_EXPECT}")
    if "--speculation" in cli:
        spec = re.search(r"\[sched\] speculation: drafted=(\d+) "
                         r"accepted=(\d+) .* rollback=(\d+)", text)
        if not spec or int(spec[1]) != int(spec[2]) + int(spec[3]):
            fail(f"cli: speculation line missing or drafted != accepted + "
                 f"rolled back ({spec and spec.groups()})")
    if "--sanitize" in cli:
        steps = re.search(r"\[done\] .*\(steps=(\d+),", text)
        checks = re.search(r"sanitize_checks=(\d+)", text)
        if not (steps and checks) or steps[1] != checks[1]:
            fail(f"cli: sanitizer checks {checks and checks[1]} in "
                 f"{steps and steps[1]} steps")
    say(f"[cli] counts as the flags say ({time.perf_counter() - t0:.1f} s "
        f"with the launcher's start-up)")


def phase_cli_group(timeout_s: float = 600.0):
    """The launcher with ``CLI`` and ``CLI_GROUP``: its ``[done]``,
    ``[group]``, ``[robust]``, ``[death]`` and ``[states]`` lines must
    say what the flags lead to (``CLI_GROUP_EXPECT``)."""
    t0 = time.perf_counter()
    text = _launch(CLI + CLI_GROUP, timeout_s)
    pats = {"done": r"^\[done\] (\d+ requests, \d+ tokens)",
            "group": r"^\[group\] (replicas=\d+ failover=\w+ "
                     r"failovers=\d+ migrated=\d+)",
            "health": r"^\[group\] .* (r0=\S+ r1=\S+)$",
            "robust": r"^\[robust\] (failed=\d+ timed_out=\d+ shed=\d+ "
                      r"rejected=\d+ internal_errors=\d+)",
            "death": r"^\[death\] (.*)$",
            "states": r"^\[states\] (.*)$"}
    got = {}
    for key, pat in pats.items():
        m = re.search(pat, text, re.M)
        got[key] = m[1] if m else None
    if got != CLI_GROUP_EXPECT:
        fail(f"cli: the replica group's lines {got}, expected "
             f"{CLI_GROUP_EXPECT}")
    say(f"[cli] the replica group's counts as the flags say "
        f"({time.perf_counter() - t0:.1f} s with the launcher's start-up)")


def phase_cli_smoke(timeout_s: float = 300.0):
    """The launcher with ``CLI_SMOKE``: the smoke configuration's head_dim
    32 through the attention kernels on the card; its ``[done]``,
    ``[robust]`` and ``[states]`` lines must say what the flags lead to
    (``CLI_SMOKE_EXPECT``)."""
    t0 = time.perf_counter()
    text = _launch(CLI_SMOKE, timeout_s)
    pats = {"done": r"^\[done\] (\d+ requests, \d+ tokens)",
            "robust": r"^\[robust\] (failed=\d+ timed_out=\d+ shed=\d+ "
                      r"rejected=\d+ callback_errors=\d+ "
                      r"internal_errors=\d+)",
            "states": r"^\[states\] (.*)$"}
    got = {k: (m[1] if (m := re.search(pat, text, re.M)) else None)
           for k, pat in pats.items()}
    if got != CLI_SMOKE_EXPECT:
        fail(f"cli: the smoke configuration's lines {got}, expected "
             f"{CLI_SMOKE_EXPECT}")
    say(f"[cli] the smoke configuration (head_dim 32) through the kernels: "
        f"counts as the flags say ({time.perf_counter() - t0:.1f} s with "
        f"the launcher's start-up)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA_PHASES}")
    ap.add_argument("--profile", action="store_true",
                    help="trace each Llama-3-8B run (slice, baselines) and "
                         "the Llama-3-70B run (archs) with torch.profiler "
                         "and print the device busy share, top kernels and "
                         "host ops")
    ap.add_argument("--runs", default="",
                    help="the Llama-3-8B runs to make, in this order, "
                         "repeats allowed (e.g. slice,e,e,slice to compare "
                         "them in turns); default: those of --phases")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (HERE / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.configs import ModelConfig, get_config, get_smoke_config
    from repro_torch.core import quantizer as Q
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import act_quant as AQ
    from repro_torch.kernels import kv4_attention as KA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import w4ax_matmul as WK
    from repro_torch.layers.common import no_tf32
    from repro_torch.models.lm import LM, QuantConfig
    from repro_torch.serving import kv_cache as KVC
    from repro_torch.serving.engine import Engine, EngineConfig

    no_tf32()
    smi = nvidia_smi()
    say(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build()
    say(f"[device] built {len(_build.SOURCES)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")

    rows: dict = {}
    cfg8b = get_config("llama3_8b")
    clock = [time.perf_counter()]

    def lap(phase: str):
        now = time.perf_counter()
        say(f"[time] {phase}: {now - clock[0]:.1f} s")
        clock[0] = now

    if "kernels" in phases:
        check_act_quant(torch, AQ, rows)
        check_gemm(torch, AQ, WK, Q, rows)
        check_gemm_archs(torch, AQ, WK, Q, rows)
        check_attention(torch, cfg8b, KVC, PA, Q, rows)
        check_decode(torch, cfg8b, KVC, PA, KA, Q, rows)
        check_k10_d80(torch, KA, Q, rows)
        check_head_dims(torch, cfg8b, KVC, PA, KA, Q, rows)
        check_spec_attention(torch, cfg8b, KVC, PA, Q, rows)
        for hkv, g in GQA:
            cfg = gqa_cfg(cfg8b, hkv, g)
            check_attention(torch, cfg, KVC, PA, Q, rows, f"G={g} C=256")
            check_decode(torch, cfg, KVC, PA, KA, Q, rows, f"G={g}")
        check_tp_kernels(torch, AQ, WK, Q, KVC, PA, cfg8b, rows)
        lap("kernels")
    if "times" in phases:
        phase_times(torch, cfg8b, KVC, PA, KA, ops)
        lap("times")
    mods = (ModelConfig, LM, Engine, EngineConfig, QuantConfig)
    if "parity" in phases:
        phase_parity(torch, np, mods)
        lap("parity")
    order = (args.runs.split(",") if args.runs else
             [r for r, *_ in RUNS
              if ("slice" if r == "slice" else "baselines") in phases])
    if set(order) - {r for r, *_ in RUNS}:
        fail(f"--runs takes runs of {[r for r, *_ in RUNS]}")
    runs = {}
    tp = {}
    if order or phases & {"spec", "specdiag", "recover", "replicas", "tp",
                          "moe", "generate", "fmpq"}:
        t0 = time.perf_counter()
        params = LM(cfg8b).init(seed=0, device="cuda")   # shared by every run
        torch.cuda.synchronize()
        say(f"[slice] Llama-3-8B random W4 weights ({cfg8b.num_layers} "
            f"layers) made in {time.perf_counter() - t0:.1f} s")
        for run in order:
            runs[run] = serve_llama(torch, np, mods, ops.KERNELS, cfg8b,
                                    params, run, args.profile)
        if order:
            lap("slice and baselines")
        if "spec" in phases:
            spec_launches = phase_spec(torch, np, mods, ops.KERNELS, cfg8b,
                                       params)
            k9 = rows.get("paged_kv4_prefill_attention_wq", {})
            if "C=5 spec" in k9:    # K9's verify shape runs in run (b)
                k9["C=5 spec"]["launches"] = spec_launches[
                    "paged_kv4_prefill_attention_wq"]
            lap("spec")
        if "specdiag" in phases:
            phase_specdiag(torch, np, mods, cfg8b, params)
            lap("specdiag")
        cfg_d, params_d = durable_model(cfg8b, params)
        if "recover" in phases:
            phase_recover(torch, np, mods, cfg_d, params_d)
            phase_recover_mesh(torch, cfg_d)
            lap("recover")
        if "replicas" in phases:
            phase_replicas(torch, np, mods, cfg_d, params_d)
            phase_replicas_mesh(torch, cfg_d, params_d)
            lap("replicas")
        if "tp" in phases:
            tp = phase_tp(torch, np, mods, cfg8b, params)
            lap("tp")
        if "moe" in phases:
            runs.update(phase_moe(torch, np, mods, ops.KERNELS, get_config,
                                  AQ, WK, Q, rows, params, smi))
            lap("moe")
        if "generate" in phases:
            runs["generate"] = phase_generate(torch, np, mods, ops.KERNELS,
                                              KA, Q, cfg8b, params, rows, smi)
            lap("generate")
        if "fmpq" in phases:
            runs["fmpq"] = phase_fmpq(torch, np, mods, ops.KERNELS, AQ, Q,
                                      cfg8b, params, rows, smi)
            lap("fmpq")
        del params
        gc.collect()
        torch.cuda.empty_cache()     # the 70B model and the cli phase's
        #                              process need the room
    if "families" in phases:
        runs["families"] = phase_families(torch, np, mods, ops.KERNELS,
                                          get_config, rows, smi)
        lap("families")
    if "famprof" in phases:
        phase_famprof(torch, np, mods, get_config, smi)
        lap("famprof")
    if "train" in phases:
        runs["train"] = phase_train(torch, np, mods, ops.KERNELS, get_config,
                                    get_smoke_config, smi)
        lap("train")
    if "archs" in phases:
        phase_archs(torch, np, mods, ops.KERNELS, get_config, args.profile)
        lap("archs")
    if "cli" in phases:
        phase_cli()
        phase_cli(CLI_SPEC)
        phase_cli_group()
        phase_cli_smoke()
        lap("cli")
    table = []
    for n in ops.KERNELS:
        if n in rows:
            counts = runs.get(PATH_OF.get(n, "slice"), {})
            row = dict(rows[n], launches=counts.get(COUNTED_AS.get(n, n)))
            if n in COUNTED_AS:
                row["launches_alone"] = counts.get(n)
            # the default configuration's launches on rank 0 of each mesh
            # (the tp phase's run b; every rank launches alike)
            row["launches_per_rank"] = {
                f"M={w}": res[0]["runs"]["b"]["launches"].get(
                    COUNTED_AS.get(n, n)) for w, res in tp.items()}
            table.append(row)
    say(smi)
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
