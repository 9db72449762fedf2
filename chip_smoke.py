#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printed on its own lines; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``) and the
   build of every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together);
2. kernels: each kernel against its plain PyTorch version on the card at
   the Llama-3-8B widths, M ∈ {1, 16, 256} — act-quant byte-exact, the
   W4Ax GEMMs to 1e-5·max|ref|, work-queue attention to
   1e-4·max(1, max|ref|) on descriptors from a real cache state — with
   CUDA-event times (median of 20) of kernel, plain version, a library
   yardstick where one exists, and the roofline bound (for attention, of
   the kernel alone on pre-folded inputs, with the whole op beside it as
   ``op_ms``/``op_plain_ms``);
3. parity: a 2-layer d_model-1024 model served on the card twice, with
   the kernels and with ``impl="ref"``: first-step logits to
   2e-2·max|logit|, greedy agreement ≥ 0.9;
4. slice: Llama-3-8B at full width and depth (random seeded weights),
   default ``EngineConfig`` but ``prefill_chunk_tokens=256``, 8 requests
   of 128–512 prompt tokens × 32 new tokens, greedy, to completion; every
   request must finish with 32 tokens, no failed or internal errors, and
   every kernel must have launched (launch counts reset just before).

The last two lines are the kernel table and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
PHASES = ("kernels", "parity", "slice")
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


# --------------------------------------------------------------- phase 2

def check_act_quant(torch, AQ, rows: dict):
    gen = torch.Generator(device="cuda").manual_seed(1)
    for bits, kern, ks in ((4, AQ.act_quant_int4, (3584, 12544)),
                           (8, AQ.act_quant_int8, (512, 1792))):
        name = f"act_quant_int{bits}"
        worst = 0.0
        for k in ks:
            for m in (1, 16, 256):
                # bf16-valued activations, as the projections hand them over
                x = torch.randn((m, k), generator=gen, device="cuda")
                x = (x * 3).bfloat16().float()
                # a block whose scale is exactly 1: every odd multiple of
                # 0.5 is a rounding tie (half to even)
                x[0, :128] = ((torch.arange(128, device="cuda") % 15) - 7) * 0.5
                x[0, 0] = 7.0 if bits == 4 else 127.0
                x[-1, -128:] = 0.0                  # an all-zero block
                pk, sk = kern(x)
                pr, sr = AQ.act_quant_ref(x, bits=bits)
                torch.cuda.synchronize()
                if not (torch.equal(pk, pr) and torch.equal(sk, sr)):
                    bad = int((pk != pr).sum())
                    fail(f"{name} M={m} K={k}: not byte-exact ({bad} bytes "
                         f"differ, scale max err "
                         f"{float((sk - sr).abs().max())})")
                worst = max(worst, float((pk.int() - pr.int()).abs().max()),
                            float((sk - sr).abs().max()))
                say(f"[kernels] {name} M={m} K={k}: byte-exact")
        m, k = 256, ks[0]
        x = torch.randn((m, k), generator=gen, device="cuda")
        out_bytes = m * k // 2 if bits == 4 else m * k
        nbytes = m * k * 4 + out_bytes + m * (k // 128) * 4
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/act_quant.cu",
            "replaces": ("src/repro/kernels/act_quant.py:52" if bits == 4
                         else "src/repro/kernels/act_quant.py:82"),
            "shape": f"M={m} K={k}",
            "max_abs_err": worst,
            "ms": time_ms(torch, lambda: kern(x)),
            "plain_ms": time_ms(torch, lambda: AQ.act_quant_ref(x, bits=bits)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
        }


def check_gemm(torch, AQ, WK, Q, rows: dict):
    gen = torch.Generator(device="cuda").manual_seed(2)
    # (N, K): q/o, k/v, up/gate, down projections of Llama-3-8B
    shapes = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))
    worst = {"w4a4_matmul": 0.0, "w4a8_matmul": 0.0}
    timed = {}
    for n, k in shapes:
        nb = k // 128
        nb4 = int(round(0.875 * nb))
        k4 = nb4 * 128
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        wp, ws = Q.quantize_weight_int4(w, group_size=128)
        for m in (1, 16, 256):
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
                     (a8, s8, w8p, w8s))):
                out = kern(*args)
                want = ref(*args)
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                tol = 1e-5 * float(want.abs().max())
                if not err <= tol:
                    fail(f"{name} M={m} N={n} K={k}: max err {err} > {tol}")
                worst[name] = max(worst[name], err)
                say(f"[kernels] {name} M={m} N={n} K={k}: max err {err:.3g}"
                    f" (tol {tol:.3g})")
                if m == 256 and (n, k) == (4096, 4096):
                    timed[name] = (m, n, args)
            # the composed split schedule against the mixed-precision oracle
            split = WK.w4ax_matmul_split(a4, s4, a8, s8, wp, ws)
            want = WK.w4ax_matmul_ref(a4, s4, a8, s8, w4p, w4s, w8p, w8s)
            err = float((split - want).abs().max())
            if not err <= 1e-5 * float(want.abs().max()):
                fail(f"w4ax_matmul_split M={m} N={n} K={k}: max err {err}")
    for name, (m, n, args) in timed.items():
        a, s, wpk, wsc = args
        kk = wpk.shape[0] * 2
        a_bytes = m * kk // 2 if name == "w4a4_matmul" else m * kk
        nbytes = (a_bytes + s.numel() * 4 + wpk.numel() + wsc.numel() * 4
                  + m * n * 4)
        ops_ = 2 * m * n * kk
        bound = max(nbytes / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S) * 1e3
        kern = WK.w4a4_matmul if name == "w4a4_matmul" else WK.w4a8_matmul
        ref = WK.w4a4_matmul_ref if name == "w4a4_matmul" \
            else WK.w4a8_matmul_ref
        # yardstick only: bf16 matmul on pre-dequantized weights
        xb = torch.randn((m, kk), generator=gen, device="cuda").bfloat16()
        wb = Q.dequantize_weight_int4(wpk, wsc).bfloat16()
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/w4ax_matmul.cu",
            "replaces": ("src/repro/kernels/w4ax_matmul.py:142"
                         if name == "w4a4_matmul"
                         else "src/repro/kernels/w4ax_matmul.py:209"),
            "shape": f"M={m} N={n} K={kk}",
            "max_abs_err": worst[name],
            "ms": time_ms(torch, lambda: kern(*args)),
            "plain_ms": time_ms(torch, lambda: ref(*args)),
            "bound_ms": bound,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops_ / INT8_OPS_PER_S else "operations"),
            "library_ms": time_ms(torch, lambda: torch.matmul(xb, wb)),
        }


def attention_case(torch, cfg, KVC):
    """A real cache state: decode rows, mid-prefill rows, a zero-history
    row, and two qlen-0 pad rows of the power-of-two row bucket."""
    hkv, d, ps = cfg.num_kv_heads, cfg.head_dim, 64
    cache = KVC.PagedKV4Cache(
        cfg, KVC.PagedKV4Config(num_pages=512, page_size=ps, max_seqs=16,
                                max_pages_per_seq=64),
        num_layer_slots=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    cache.k_pool.copy_(torch.randint(0, 256, cache.k_pool.shape,
                                     generator=gen, device="cuda",
                                     dtype=torch.int32).to(torch.uint8))
    cache.v_pool.copy_(torch.randint(0, 256, cache.v_pool.shape,
                                     generator=gen, device="cuda",
                                     dtype=torch.int32).to(torch.uint8))
    # (history, chunk): 3 decode rows, 2 mid-prefill rows, 1 first chunk
    rows = ((300, 1), (129, 1), (64, 1), (128, 256), (200, 100), (0, 256))
    for slot, (ctx, take) in enumerate(rows):
        assert cache.allocate_seq(slot, ctx + take)
        cache.seq_len[slot] = ctx
    starts = [c for c, _ in rows]
    takes = [t for _, t in rows]
    nb, cb = 8, 256
    desc = cache.work_queue_np(list(range(len(rows))), starts, takes,
                               pad_row=nb * hkv)
    q = torch.randn((nb, cb, cfg.num_heads, d), generator=gen,
                    device="cuda").bfloat16()
    kn = torch.randn((nb, cb, hkv, d), generator=gen, device="cuda") * 4
    vn = torch.randn((nb, cb, hkv, d), generator=gen, device="cuda") * 4
    args = (q, kn, vn, cache.k_pool[0], cache.k_scale, cache.k_zero,
            cache.v_pool[0], cache.v_scale, cache.v_zero,
            torch.from_numpy(desc).cuda())
    return args, desc, takes


def attention_bound(desc, takes, hkv: int, g: int, d: int):
    """Bytes and f32 operations the K9 kernel needs for this descriptor
    array, counting only each row's valid queries (its q_len) and each
    item's valid keys: per (query, key) pair 4·D operations (q·k and p·v);
    the folded queries (q·s_k, Σ q·z_k, q/√D) and the fp chunk's k/v read
    once per row, the int4 keys/values of each page item, the descriptor
    array, the V affine, and each valid query's partial (acc, l, m)."""
    flops = nbytes = 0
    for row in set(int(r) for r in desc[desc[:, 2] > 0, 0]):
        ql = takes[row // hkv]
        items = desc[(desc[:, 0] == row) & (desc[:, 2] > 0)]
        if (items[:, 3] == 0).any():
            nbytes += ql * g * (d + 1) * 4               # q·s_k/√D, Σ q·z_k
        for _, _, count, kind in items:
            count = int(count)
            if kind == 0:
                flops += ql * g * count * 4 * d
                nbytes += count * (d // 2) * 2           # int4 k and v
            else:
                keys = sum(min(qi + 1, count) for qi in range(ql))
                flops += keys * g * 4 * d
                nbytes += ql * g * d * 4 + count * d * 4 * 2  # q/√D, k, v
            nbytes += ql * g * (d + 2) * 4               # acc, l, m
    nbytes += desc.size * 4 + 2 * hkv * d * 4
    return nbytes, flops


def check_attention(torch, cfg, KVC, PA, rows: dict):
    args, desc, takes = attention_case(torch, cfg, KVC)
    out = PA.paged_kv4_prefill_attention_wq(*args)
    want = PA.paged_kv4_prefill_attention_wq_ref(*args)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    if not (torch.isfinite(out).all() and err <= tol):
        fail(f"paged_kv4_prefill_attention_wq: max err {err} > {tol}")
    q, kn, vn, k_pool, ks, kz, v_pool, vs, vz, desc_t = args
    b, c, hq, d = q.shape
    hkv = cfg.num_kv_heads
    g = hq // hkv
    say(f"[kernels] paged_kv4_prefill_attention_wq W={desc.shape[0]} "
        f"C={c}: max err {err:.3g} (tol {tol:.3g})")
    # the kernel alone on pre-folded inputs, against its plain version;
    # the whole op (pre-fold, kernel, combine with the engine's host plan)
    # is timed beside it
    folded = PA.prefold(q, kn, vn, ks, kz, vs, vz)
    plan = PA.combine_plan(desc[:, 0], b * hkv, "cuda")
    nbytes, flops = attention_bound(desc, takes, hkv, g, d)
    rows["paged_kv4_prefill_attention_wq"] = {
        "name": "paged_kv4_prefill_attention_wq", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:622",
        "shape": f"B={b} C={c} Hq={hq} D={d} W={desc.shape[0]}",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: PA.paged_kv4_partials(
            desc_t, *folded, k_pool, v_pool, g)),
        "plain_ms": time_ms(torch, lambda: PA.paged_kv4_partials_ref(
            desc_t, *folded, k_pool, v_pool, g)),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                        flops / F32_FLOPS_PER_S) * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / F32_FLOPS_PER_S else "operations"),
        "library_ms": None,
        "op_ms": time_ms(torch, lambda: PA.paged_kv4_prefill_attention_wq(
            *args, plan=plan)),
        "op_plain_ms": time_ms(
            torch, lambda: PA.paged_kv4_prefill_attention_wq_ref(
                *args, plan=plan)),
    }


# ------------------------------------------------------- phases 3 and 4

def serve(torch, np, Engine, EngineConfig, QuantConfig, cfg, params, impl,
          prompts, max_new, ecfg):
    eng = Engine(cfg, params, QuantConfig(impl=impl), ecfg, device="cuda")
    first = []
    inner = eng._guarded_forward

    def capture(*a, **k):
        logits = inner(*a, **k)
        if not first:
            first.append(logits.copy())
        return logits

    eng._guarded_forward = capture
    for i, p in enumerate(prompts):
        eng.add_request(i, p, max_new)
    step_s = []
    while eng.sched.has_work and eng.steps < 10_000:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return eng, first[0] if first else None, step_s


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


def phase_parity(torch, np, mods):
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    cfg = ModelConfig(name="parity", family="dense", num_layers=2,
                      d_model=1024, num_heads=8, num_kv_heads=2,
                      head_dim=128, d_ff=2048, vocab_size=512,
                      rope_theta=500_000.0)
    params = LM(cfg).init(seed=0, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (40, 7, 23, 64, 13, 29)]
    ecfg = EngineConfig(max_batch=8, num_pages=128, page_size=64,
                        max_pages_per_seq=16, prefill_chunk_tokens=48,
                        kv_range=4.0)
    res = {}
    for impl in ("auto", "ref"):
        eng, first, _ = serve(torch, np, Engine, EngineConfig, QuantConfig,
                              cfg, params, impl, prompts, 16, ecfg)
        res[impl] = (check_run(eng, len(prompts), 16, cfg.vocab_size,
                               f"parity[{impl}]"), first)
    (tk, lk), (tr, lr) = res["auto"], res["ref"]
    err = float(np.abs(lk - lr).max())
    tol = 2e-2 * float(np.abs(lr).max())
    if not err <= tol:
        fail(f"parity: first-step logits max err {err} > {tol}")
    total = sum(len(v) for v in tr.values())
    agree = sum(a == b for i in tr for a, b in zip(tk[i], tr[i])) / total
    say(f"[parity] first-step logits max err {err:.4g} (tol {tol:.4g}); "
        f"greedy agreement {agree:.4f} over {total} tokens")
    if agree < 0.9:
        fail(f"parity: greedy agreement {agree} < 0.9")


def profile_table(torch, prof, wall_s: float):
    """Top kernels by device time, the device busy share of the run, and
    the top host operations by their own CPU time."""
    events = prof.key_averages()

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
             "top device time:"]
    for e in sorted(on_dev, key=dev_us, reverse=True)[:25]:
        lines.append(f"{dev_us(e) / 1e3:10.2f} ms {e.count:7d}x  {e.key[:90]}")
    lines.append("top host (self CPU) time:")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:20]:
        lines.append(f"{e.self_cpu_time_total / 1e3:10.2f} ms {e.count:7d}x  "
                     f"{e.key[:90]}")
    return "\n".join(lines)


def phase_slice(torch, np, mods, KERNELS, profile=False):
    ModelConfig, LM, Engine, EngineConfig, QuantConfig = mods
    from repro_torch.configs import get_config
    cfg = get_config("llama3_8b")
    t0 = time.perf_counter()
    params = LM(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    say(f"[slice] Llama-3-8B random W4 weights ({cfg.num_layers} layers) "
        f"made in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 513, 8)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist() for n in lens]
    ecfg = EngineConfig(prefill_chunk_tokens=256)
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
                               cfg, params, "auto", prompts, 32, ecfg)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        say("[slice] profiled run (times include profiler overhead):\n"
            + profile_table(torch, prof, wall))
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    check_run(eng, len(prompts), 32, cfg.vocab_size, "slice")
    if first is None or not np.isfinite(first).all():
        fail("slice: first-step logits missing or not finite")
    for name, n in launches.items():
        if n <= 0:
            fail(f"slice: kernel {name} was never launched")
    if eng.attn_forwards <= 0:
        fail("slice: no step took the work-queue attention path")
    toks = eng.tokens_generated
    say(f"[slice] prompts {lens.tolist()}; {eng.steps} steps, {toks} tokens "
        f"in {wall:.3f} s = {toks / wall:.2f} tok/s; median step "
        f"{statistics.median(step_s) * 1e3:.2f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"[slice] step ms {[round(s * 1e3, 2) for s in step_s]}")
    say(f"[slice] launches {json.dumps(launches)}")
    say(f"[slice] counters {json.dumps(eng.counters())}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--profile", action="store_true",
                    help="trace the slice run with torch.profiler and print "
                         "the device busy share, top kernels and host ops")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (HERE / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np
    from repro_torch.configs import ModelConfig, get_config
    from repro_torch.core import quantizer as Q
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import act_quant as AQ
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
    if "kernels" in phases:
        check_act_quant(torch, AQ, rows)
        check_gemm(torch, AQ, WK, Q, rows)
        check_attention(torch, get_config("llama3_8b"), KVC, PA, rows)
    mods = (ModelConfig, LM, Engine, EngineConfig, QuantConfig)
    if "parity" in phases:
        phase_parity(torch, np, mods)
    launches = {}
    if "slice" in phases:
        launches = phase_slice(torch, np, mods, ops.KERNELS, args.profile)
    table = [dict(rows[n], launches=launches.get(n)) for n in ops.KERNELS
             if n in rows]
    say(smi)
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
