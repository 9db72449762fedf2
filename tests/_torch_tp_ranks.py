"""The tensor-parallel tests' workloads, run by the port's single-device
engine in the test process and by the ranks ``launch.mesh.spawn`` starts
(gloo on the CPU). This module imports only the port: a spawned rank
imports it, and no ``repro`` or JAX module.

The workloads are the reference's ``tests/serving/test_sharded_engine.py``
(mixed prefill and decode, decode-only, the prefix cache, the dense
schedule, speculation, fault isolation, a full snapshot at step 4), served
with the sanitizers on, which under a mesh also compare every rank's
tokens and scheduler state after every step; and the grouping workload
(:func:`run_grouping`), whose every forward's logits a mesh must give bit
for bit as one device does under :func:`serial_seams`.
"""
import contextlib
import sys
import time

import numpy as np
import torch

from repro_torch.core import qlinear as QL
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.lm import LM, QuantConfig
from repro_torch.serving import engine as E
from repro_torch.serving.api import RequestState, SamplingParams
from repro_torch.serving.engine import Engine, EngineConfig, _row_linear
from repro_torch.serving.faults import Fault, FaultInjector

ENGINE = dict(max_batch=4, num_pages=64, page_size=8, kv_range=4.0,
              sanitize=True)
SNAPSHOT_AT = 4


def prompts(vocab: int, lens, seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


def _outcome(eng: Engine) -> dict:
    done = eng.sched.finished
    return {
        "tokens": {r.request_id: list(r.generated) for r in done},
        "states": {r.request_id: r.state.value for r in done},
        "steps": eng.steps, "forward_calls": eng.forward_calls,
        "attn_work_items": eng.attn_work_items,
        "per_shard": list(eng.attn_work_items_per_shard),
        "prefix_hit_tokens": eng.prefix_hit_tokens,
        "failed_count": eng.failed_count,
        "internal_errors": eng.internal_errors,
        "sanitize_checks": eng.sanitize_checks,
        "spec": (eng.spec_draft_tokens, eng.spec_accepted_tokens,
                 eng.spec_rollback_tokens),
        "pages_free": eng.cache.pages_free,
        "refs_zero": bool((eng.cache.ref == 0).all()),
    }


def _engine(model, mesh, faults=None, **ecfg):
    cfg, params, axes, quant = model
    return Engine(cfg, params, quant, EngineConfig(**ENGINE, **ecfg),
                  device="cpu", mesh=mesh, param_axes=axes, faults=faults)


def _batch(model, mesh, reqs, max_new, **ecfg) -> dict:
    eng = _engine(model, mesh, **ecfg)
    for i, p in enumerate(reqs):
        eng.add_request(i, p, max_new)
    eng.run(max_steps=300)
    return _outcome(eng)


FULL = ("mixed", "decode_only", "dense", "prefix_cache", "spec",
        "fault", "snapshot")


def run_workloads(model, mesh, blob_in=None, names=FULL) -> dict:
    """The ``names`` workloads on ``model`` (cfg, params, axes, quant) →
    outcome per workload; ``mesh`` None is one device. The ``snapshot``
    workload also restores its own blob into a new engine
    (``restored_own``) and ``blob_in``, a full snapshot taken by the other
    kind of engine at the same step, into another (``restored``)."""
    v = model[0].vocab_size
    out = {}
    if "mixed" in names:
        out["mixed"] = _batch(model, mesh, prompts(v, (11, 19, 7, 26)), 8)
    if "decode_only" in names:
        out["decode_only"] = _batch(model, mesh, prompts(v, (1, 2, 1, 3)),
                                    12)
    if "dense" in names:
        out["dense"] = _batch(model, mesh, prompts(v, (9, 14)), 6,
                              attention_schedule="dense")
    if "prefix_cache" in names:
        _prefix_cache(model, mesh, out)
    if "spec" in names:
        _spec(model, mesh, out)
    if "fault" in names:
        _fault(model, mesh, out)
    if "snapshot" in names:
        _snapshot(model, mesh, out, blob_in)
    return out


def _prefix_cache(model, mesh, out):
    v = model[0].vocab_size
    # published prefix pages are host-global: the second request decodes
    # from pages the first one's forward wrote
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, v, 16).tolist()
    sfx = [rng.integers(1, v, n).tolist() for n in (5, 9)]
    eng = _engine(model, mesh, prefix_cache=True, max_pages_per_seq=16)
    eng.add_request(0, prefix + sfx[0], 6)
    eng.run(max_steps=200)
    eng.add_request(1, prefix + sfx[1], 6)
    eng.run(max_steps=200)
    out["prefix_cache"] = _outcome(eng)


def _spec(model, mesh, out):
    # greedy speculation on cycle-prone prompts, without and with drafts
    for k in (0, 4):
        eng = _engine(model, mesh)
        for i, p in enumerate(([188] * 12, [49] * 8, [188] * 10)):
            eng.submit(p, SamplingParams(max_new_tokens=20, temperature=0.0,
                                         speculation=k), request_id=i)
        eng.run(max_steps=300)
        out[f"spec{k}"] = _outcome(eng)


def _fault(model, mesh, out):
    # a NaN-logits fault quarantines one request; the others decode on
    v = model[0].vocab_size
    eng = _engine(model, mesh, faults=FaultInjector(
        [Fault("forward", step=3, action="nan", row=0)]))
    for i, p in enumerate(prompts(v, (9, 12, 7), seed=13)):
        eng.add_request(i, p, 6)
    eng.run(max_steps=300)
    out["fault"] = _outcome(eng)


def _snapshot(model, mesh, out, blob_in):
    # a full snapshot mid-decode, and the uninterrupted run
    v = model[0].vocab_size
    eng = _engine(model, mesh)
    for i, p in enumerate(prompts(v, (10, 15), seed=17)):
        eng.add_request(i, p, 8)
    for _ in range(SNAPSHOT_AT):
        eng.step()
    out["blob"] = eng.snapshot(full=True)
    eng.run(max_steps=300)
    out["snapshot"] = _outcome(eng)
    out["restored_own"] = restore_and_run(model, mesh, out["blob"])
    if blob_in is not None:
        out["restored"] = restore_and_run(model, mesh, blob_in)


def restore_and_run(model, mesh, blob: str) -> dict:
    cfg, params, axes, quant = model
    eng = Engine.restore(blob, cfg, params, quant, EngineConfig(**ENGINE),
                         device="cpu", mesh=mesh, param_axes=axes)
    eng.run(max_steps=300)
    return _outcome(eng)


@contextlib.contextmanager
def serial_seams(m: int):
    """While open, the single-device engine computes every row-parallel
    projection (wo, w_down) as ``m`` ranks' seams do: K-slices taken here
    by plain indexing of the whole weights, each a GEMM with f32 output,
    summed in rank order, the bias added once, rounded to bf16 once."""
    def row_linear(p, x, quant, mesh):
        assert mesh is None
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


GROUPING_FRACTIONS = (1.0, 0.5)


def grouping_model(cfg) -> tuple:
    """The port's own seeded weights on ``cfg`` → (cfg, params, axes)."""
    lm = LM(cfg)
    params = lm.init(seed=11, device="cpu")
    return cfg, params, lm.axes(params)


def run_grouping(model, mesh) -> dict:
    """The mixed workload on ``model`` (:func:`grouping_model`) at each of
    ``GROUPING_FRACTIONS`` → fraction → (tokens, every forward's logits)."""
    cfg, params, axes = model
    out = {}
    for frac in GROUPING_FRACTIONS:
        eng = Engine(cfg, params, QuantConfig(int4_fraction=frac, impl="ref"),
                     EngineConfig(**ENGINE), device="cpu", mesh=mesh,
                     param_axes=axes)
        logits = []
        inner = eng._guarded_forward

        def capture(*a, inner=inner, logits=logits, **k):
            y = inner(*a, **k)
            logits.append(np.array(y))
            return y

        eng._guarded_forward = capture
        for i, p in enumerate(prompts(cfg.vocab_size, (11, 19, 7, 26))):
            eng.add_request(i, p, 8)
        eng.run(max_steps=300)
        out[frac] = (_outcome(eng)["tokens"], logits)
    return out


def seam_outputs(mesh, cases) -> list:
    """``_row_linear`` on this rank's K-slice of each case (``x``, the
    packed projection per rank, the quant config) → the bf16 results, as
    int16 bits."""
    out = []
    for xs, shards, quant in cases:
        r = mesh.model_rank
        y = _row_linear(shards[r], xs[r], quant, mesh)
        out.append(y.view(torch.int16).numpy())
    return out


def foreign_modules() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("repro", "jax", "jaxlib"))


def rank_main(rank, world, device, model, blob_in, seam_cases,
              names=FULL, grouping=None):
    """A spawned rank: the ``names`` workloads on its shard, the seam
    cases, the grouping workload on ``grouping`` (a
    :func:`grouping_model`, if given), and the JAX and ``repro`` modules
    it loaded (none)."""
    mesh = make_local_mesh(1, world)
    out = run_workloads(model, mesh, blob_in, names)
    out["seam"] = seam_outputs(mesh, seam_cases)
    if grouping is not None:
        out["grouping"] = run_grouping(grouping, mesh)
    out["foreign"] = foreign_modules()
    return out


def import_all(rank, world, device, mods) -> list:
    """A spawned rank: import every port module ``mods``, join the mesh →
    the JAX and ``repro`` modules loaded (none)."""
    import importlib
    for m in mods:
        importlib.import_module(m)
    make_local_mesh(1, world)
    return foreign_modules()


def failed_ids(outcome: dict) -> list:
    return sorted(rid for rid, st in outcome["states"].items()
                  if st == RequestState.FAILED.value)


def fail_on_rank_1(rank, world, device):
    """Rank 1 raises; rank 0 waits in a barrier for it."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()


def forward_fails_on_rank_1(rank, world, device, model):
    """Rank 1's forward raises at step 2 (an error of its own, not an
    injected fault) while rank 0 goes on into that forward's seams."""
    mesh = make_local_mesh(1, world)
    eng = _engine(model, mesh)
    if rank == 1:
        inner = eng._unified_body

        def body(*a, **k):
            if eng.steps == 2:
                raise RuntimeError("rank 1's forward fails on purpose")
            return inner(*a, **k)

        eng._unified_body = body
    for i, p in enumerate(prompts(model[0].vocab_size, (11, 19))):
        eng.add_request(i, p, 8)
    eng.run(max_steps=50)
    return _outcome(eng)


def sleep(rank, world, device, seconds):
    time.sleep(seconds)
