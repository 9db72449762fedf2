"""The port's dry run (``launch/dryrun.py``, ``launch/specs.py``) against
the reference on the CPU, with no XLA compile:

* ``SHAPES``, ``applicable_shapes``, ``all_cells`` and the analytic
  parameter counts equal the reference's for all 12 archs;
* ``LM.axes`` equals the reference's ``axes`` (``LM.init``) and ``qaxes``
  (``LM.quantize``) leaf by leaf after unstacking, for every family on
  its smoke config, and ``specs.shapes_of_init`` gives the reference's
  leaf shapes and dtypes;
* for every cell of ``all_cells(include_paper_models=True)`` on both
  production meshes at full size, one rank's bytes of params, optimizer
  state, cache and batch equal those from the reference's
  ``jax.eval_shape`` shapes and its ``tree_pspecs``/``cache_pspecs`` on a
  stub mesh (the reference's specs are pure functions of a mesh's
  ``axis_names`` and ``shape``), and each cache leaf's spec is the
  reference's, mapped by meaning (no layer axis; the VLM's image K/V
  head-major);
* the FLOPs traced at one and two units of depth and extended equal the
  whole trace; one rank's counted collectives equal a hand count; the
  live-bytes counter a hand count; the planning mesh refuses host
  exchanges; the rank's shard shapes are ``serial_train``'s;
* the expert counts of the MoE dispatch (``scatter_add_``, which has a
  meta kernel) give ``bincount``'s dispatch;
* ``python -m repro_torch.launch.dryrun`` runs the reference smoke
  test's cells (``tests/launch/test_sharding.py``
  ``test_dryrun_smoke_subprocess``) and writes their records.
"""
import functools
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import base as JB
from repro.launch.specs import input_specs as j_input_specs
from repro.launch.specs import shapes_of_init as j_shapes_of_init
from repro.models.lm import LM as JLM
from repro.models.lm import QuantConfig as JQuantConfig
from repro.parallel import sharding as JSH
from repro.training import optimizer as JOPT
from repro_torch.configs import base as B
from repro_torch.convert import axes_from_jax
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.layers import mlp as MLP
from repro_torch.models.lm import LM, QuantConfig
from repro_torch.parallel import mesh as PM
from repro_torch.training import optimizer as OPT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QREF = QuantConfig(impl="ref")


class StubMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


PROD = {False: {"data": 16, "model": 16},
        True: {"pod": 2, "data": 16, "model": 16}}


# ------------------------------------------------------------ configs

def test_shapes_and_cells_equal_reference():
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in B.SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.kind)
        for k, v in JB.SHAPES.items()}
    for arch in B.ARCH_IDS:
        assert B.applicable_shapes(B.get_config(arch)) == \
            JB.applicable_shapes(JB.get_config(arch))
    assert B.all_cells() == JB.all_cells()
    assert B.all_cells(include_paper_models=True) == \
        JB.all_cells(include_paper_models=True)
    assert len(B.all_cells()) == 31


@pytest.mark.parametrize("arch", B.ARCH_IDS)
def test_param_counts_equal_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        mine, ref = getattr(B, get)(arch), getattr(JB, get)(arch)
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()


# ------------------------------------------------------------- axes

def _port_lm(cfg, quantized):
    return LM(cfg, QREF if quantized else None)


@pytest.mark.parametrize("quantized", (False, True), ids=("fp", "packed"))
@pytest.mark.parametrize("arch", B.ARCH_IDS)
def test_axes_equal_reference(arch, quantized):
    """Every family's axes are the reference's (``LM.init``'s, or
    ``LM.quantize``'s ``qaxes``) without ``"layers"``, and the meta
    params have the reference's leaves: shapes and dtypes, each stack
    unstacked."""
    cfg, jcfg = B.get_smoke_config(arch), JB.get_smoke_config(arch)
    lm = _port_lm(cfg, quantized)
    params = SP.shapes_of_init(lm, quantized)
    jshapes, jaxes = j_shapes_of_init(
        JLM(jcfg, JQuantConfig(impl="ref") if quantized else None),
        quantized)
    n_cross = lm.n_groups if cfg.family == "vlm" else 0
    assert lm.axes(params) == axes_from_jax(
        jax.tree.map(tuple, jaxes, is_leaf=lambda x: isinstance(x, tuple)),
        lm._n_blocks(), n_cross)

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            return {p: v for k, sub in tree.items()
                    for p, v in flat(sub, prefix + (k,)).items()}
        return {prefix: tree}
    ref = flat(jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                            jshapes))
    for key in ("blocks", "cross_blocks"):
        for path, (shp, dt) in list(ref.items()):
            if path[0] == key:
                ref[path] = (shp[1:], dt)       # one layer of the stack
    for key, sub in params.items():
        tree = sub[0] if key in ("blocks", "cross_blocks") else sub
        for path, t in flat(tree, (key,)).items():
            assert ref.pop(path) == (tuple(t.shape),
                                     str(t.dtype).split(".")[1]), path
    assert not ref


def test_axes_refusals_stay():
    """The axes are every family's; running over a mesh stays the dense
    and moe families' (ROADMAP Queue 1 item 16), in the same words."""
    mesh = PM.Mesh(shape={"data": 1, "model": 2})
    for arch in ("zamba2_2p7b", "rwkv6_1p6b", "llama3p2_vision_90b",
                 "hubert_xlarge"):
        lm = LM(B.get_smoke_config(arch))
        for call in (lambda: lm.init_fp(device="cpu", mesh=mesh),
                     lambda: lm.train_specs(mesh),
                     lambda: lm.train_hidden(
                         {}, torch.zeros((1, 1), dtype=torch.long),
                         mesh=mesh, specs={})):
            with pytest.raises(NotImplementedError,
                               match="training over a mesh covers the "
                                     "dense and moe families.*item 16"):
                call()


# ------------------------------------------------ per-rank bytes

def _ref_size(mesh, entry) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in names)


def _ref_bytes(tree, specs, mesh) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(math.prod(d // _ref_size(mesh, e) for d, e in
                         zip(s.shape, tuple(sp) + (None,) * s.ndim))
               * np.dtype(s.dtype).itemsize
               for s, sp in zip(leaves, spec_leaves))


@functools.lru_cache(maxsize=None)
def _ref_init(arch: str, quantized: bool):
    """The reference's ``jax.eval_shape`` params and axes of ``arch`` (and
    the AdamW state's shapes of the fp ones), once per test process."""
    jlm = JLM(JB.get_config(arch),
              quant=JQuantConfig(impl="ref") if quantized else None)
    params, axes = j_shapes_of_init(jlm, quantized=quantized)
    opt = None if quantized else jax.eval_shape(JOPT.adamw_init, params)
    return jlm, params, axes, opt


@functools.lru_cache(maxsize=None)
def _ref_cache(arch: str, shape_name: str):
    shape = JB.SHAPES[shape_name]
    lmq = _ref_init(arch, True)[0]
    return jax.eval_shape(lambda: lmq.init_cache(shape.global_batch,
                                                 shape.seq_len))


def _ref_cell(arch: str, shape_name: str, mesh) -> dict:
    """The reference's ``build_cell`` arguments and specs (its code, on
    a stub mesh: ``NamedSharding`` needs devices, so the batch rule of
    ``specs._batch_shardings`` is restated) → part → (tree, specs)."""
    jcfg, shape = JB.get_config(arch), JB.SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    parts = {}
    if shape.kind == "train":
        _, params, axes, opt = _ref_init(arch, False)
        psp = JSH.tree_pspecs(axes, params, mesh, JSH.TRAIN_RULES)
        parts["params"] = (params, psp)
        parts["opt_state"] = (opt, {"m": psp, "v": psp, "step": P()})
    else:
        lmq, params, qaxes, _ = _ref_init(arch, True)
        parts["params"] = (params, JSH.tree_pspecs(qaxes, params, mesh,
                                                   JSH.SERVE_RULES))
        if not jcfg.encoder_only:
            cache = _ref_cache(arch, shape_name)
            parts["cache"] = (cache, JSH.cache_pspecs(
                cache, mesh, seq_parallel=(b == 1)))
    ins = j_input_specs(arch, shape_name)
    baxes = JSH.batch_spec(mesh)[0]
    parts["batch"] = (ins, {
        k: P(*([baxes if v.shape[0] % _ref_size(mesh, baxes) == 0 else None]
               + [None] * (v.ndim - 1))) for k, v in ins.items()})
    return parts


def _cache_leaves(cache, specs, path=()):
    """(path, layer, leaf spec) of the port's cache tree."""
    if isinstance(cache, dict):
        for k, v in cache.items():
            yield from _cache_leaves(v, specs[k], path + (k,))
    elif isinstance(cache, list):
        for i, (v, s) in enumerate(zip(cache, specs)):
            for p, _, sp in _cache_leaves(v, s, path):
                yield p, i, sp
    else:
        yield path, None, specs


@pytest.mark.parametrize("arch", B.CELL_ARCH_ORDER)
def test_rank_bytes_equal_reference(arch):
    """Every cell of ``arch`` on both production meshes, at full size:
    the port's per-rank bytes of each part equal the reference's, and
    each cache leaf's spec is the reference's without the layer axis
    (the image K/V's time and head entries swapped: the port's is
    head-major)."""
    for shape_name in B.applicable_shapes(B.get_config(arch)):
        for multi_pod in (False, True):
            mesh = make_production_mesh(multi_pod=multi_pod)
            stub = StubMesh(PROD[multi_pod])
            cell = SP.build_cell(arch, shape_name, mesh, quant=QREF)
            ref = _ref_cell(arch, shape_name, stub)
            got = cell.argument_bytes_by(mesh)
            assert got == {k: _ref_bytes(t, s, stub)
                           for k, (t, s) in ref.items()}, \
                (shape_name, multi_pod)
            if "cache" not in ref:
                continue
            jspecs = ref["cache"][1]
            for path, _, spec in _cache_leaves(cell.args["cache"],
                                                cell.specs["cache"]):
                want = tuple(jspecs[path[0]][path[1]])[1:]
                if path[0] == "cross_kv":       # [B, T, H, D] → [B, H, T, D]
                    want = (want[0], want[2], want[1], want[3])
                assert spec == want, (shape_name, multi_pod, path)


def test_qwen2_72b_figures():
    """The figures of the reference's specs at 16 × 16 for Qwen2-72B:
    1.1365 GB of f32 params a rank training, 3.2159 GB of packed params
    serving, 1.3527 GB of ``decode_32k`` cache."""
    mesh = make_production_mesh()
    train = SP.build_cell("qwen2_72b", "train_4k", mesh).argument_bytes_by(
        mesh)
    dec = SP.build_cell("qwen2_72b", "decode_32k", mesh,
                        quant=QREF).argument_bytes_by(mesh)
    assert round(train["params"] / 1e9, 4) == 1.1365
    assert train["opt_state"] == 2 * train["params"] + 4
    assert round(dec["params"] / 1e9, 4) == 3.2159
    assert round(dec["cache"] / 1e9, 4) == 1.3527


def test_trace_predicate():
    """One rank is traced exactly for ``train`` of the dense family on a
    mesh without a pod axis, and of the moe family where data is 1."""
    for arch, shape_name in B.all_cells(include_paper_models=True):
        cfg = B.get_config(arch)
        kind = B.SHAPES[shape_name].kind
        for shape in ({"data": 16, "model": 16}, {"data": 1, "model": 4},
                      {"pod": 2, "data": 16, "model": 16}):
            mesh = PM.planning_mesh(shape)
            why = SP.trace_refusal(cfg, kind, mesh)
            can = kind == "train" and "pod" not in shape and (
                cfg.family == "dense"
                or (cfg.family == "moe" and shape["data"] == 1))
            assert (why is None) == can, (arch, shape_name, shape, why)


# ------------------------------------------------ FLOPs and the trace

FLOP_CASES = (("llama3_8b", "train_4k"), ("llama3_8b", "prefill_32k"),
              ("llama3_8b", "decode_32k"), ("moonshot_v1_16b_a3b",
                                            "train_4k"),
              ("zamba2_2p7b", "prefill_32k"), ("rwkv6_1p6b", "train_4k"),
              ("llama3p2_vision_90b", "decode_32k"),
              ("hubert_xlarge", "prefill_32k"))


@pytest.mark.parametrize("arch,shape_name", FLOP_CASES)
def test_unit_flops_equal_whole_trace(arch, shape_name):
    """``global_flops`` (one and two units traced, extended) equals the
    whole trace at three units of the smoke config."""
    cfg = SP.with_depth(B.get_smoke_config(arch), 3)
    shape = SP.SMOKE_SHAPES[shape_name]
    cell = SP.build_cell(arch, shape_name, PM.planning_mesh({}), quant=QREF,
                         cfg=cfg, shape=shape)
    whole = DR.count_flops(cell.step(), cell.args)
    assert whole > 0
    assert DR.global_flops(arch, shape, cfg, QREF) == whole


def test_live_bytes_hand_count():
    x = torch.empty(1000, device="meta")                # 4,000 B, an argument
    with DR.LiveBytes([x]) as live:
        y = x * 2                                       # + 4,000
        z = y + 1                                       # + 4,000 → 8,000
        del y                                           # − 4,000
        v = z.view(10, 100)                             # a view: + 0
        x.add_(1)                                       # in place: + 0
        w = torch.empty(500, device="meta")             # + 2,000 → 6,000
        assert live.live == 6000
        u = torch.cat([z, z])                           # + 8,000 → 14,000
        del u, z                                        # − 8,000 (v holds z)
    assert (live.peak, live.live) == (14000, 6000)
    del v, w
    assert live.live == 0


def test_planning_mesh_has_no_host_exchange():
    mesh = PM.planning_mesh({"data": 2, "model": 2},
                            PM.CountingComm({"data": 2, "model": 2}))
    t = torch.zeros(1)
    with pytest.raises(RuntimeError, match="planning mesh"):
        PM.host_all_gather(t, mesh)
    with pytest.raises(RuntimeError, match="planning mesh"):
        PM.broadcast_float(1.0, mesh)
    with pytest.raises(RuntimeError, match="planning mesh"):
        PM.host_barrier(mesh)
    with pytest.raises(RuntimeError, match="planning mesh"):
        PM.differing_ranks("x", mesh)
    with pytest.raises(RuntimeError):
        torch.empty(1, device="meta").item()
    assert make_production_mesh(multi_pod=True).axis_names == (
        "pod", "data", "model")
    assert make_production_mesh().world == 256


def test_train_rank_collectives_hand_count():
    """One ``train`` rank of the smoke Llama-3-8B on a 4 × 2 planning
    mesh (8 × 64 tokens, one loss chunk): every leaf is sharded over
    "data" (FSDP) and over "model" where its TP axis divides.

    data: each leaf gathered where used — the embedding, the final norm,
    each layer's 9 leaves twice (forward and the remat recompute), the
    head twice (its loss chunk under remat) — plus the mask count and
    the loss (0-d f32); each leaf's gradient summed back by one
    all-to-all of its gathered size. model: the f32 row seams (the
    embedding lookup, and each layer's wo and w_down in the forward; in
    the recompute only wo's, since the checkpoint stops recomputing
    after the last tensor the backward needs), the head's bf16
    vocabulary columns twice, and the bf16 gradients of each fanout
    (each layer's attention and MLP input, the head's input). world:
    the global norm's per-leaf sums."""
    cfg = B.get_smoke_config("llama3_8b")
    mesh = PM.planning_mesh({"data": 4, "model": 2})
    cell = SP.build_cell("llama3_8b", "train_4k", mesh, cfg=cfg,
                         shape=SP.SMOKE_SHAPES["train_4k"])
    got = DR.trace_rank(cell, mesh)["collectives"]["by_axis"]

    def pairs_of(tree, specs):
        return list(zip(OPT.tree_leaves(tree), OPT.spec_leaves(specs)))
    pairs = pairs_of(cell.args["params"], cell.specs["params"])
    assert all("data" in s for _, s in pairs)
    gathered = {}                       # a leaf's bytes, gathered over data

    def full(t, s):
        return t.numel() * 4 // (2 if "model" in s else 1)
    blocks = cell.args["params"]["blocks"]
    specs = cell.specs["params"]
    for name in ("embed", "final_norm", "lm_head"):
        gathered[name] = sum(full(t, s) for t, s in pairs_of(
            cell.args["params"][name], specs[name]))
    layer = [sum(full(t, s) for t, s in pairs_of(b, sp))
             for b, sp in zip(blocks, specs["blocks"])]
    leaves_per_layer = len(pairs_of(blocks[0], specs["blocks"][0]))
    assert leaves_per_layer == 9
    n_layers = len(blocks)
    rows, d = 8 // 4 * 64, cfg.d_model          # one data rank's tokens
    act32, act16 = rows * d * 4, rows * d * 2
    head16 = rows * cfg.vocab_size // 2 * 2
    want = {
        "all-gather data": [
            2 + 2 * 9 * n_layers + 2 + 2,
            gathered["embed"] + gathered["final_norm"] + 2 * sum(layer)
            + 2 * gathered["lm_head"] + 2 * 4 * 4],
        "all-to-all data": [len(pairs), sum(full(t, s) for t, s in pairs)],
        "all-gather model": [
            (1 + 2 * n_layers + n_layers) + 2 + (2 * n_layers + 1),
            2 * act32 * (1 + 3 * n_layers) + 2 * 2 * head16
            + 2 * act16 * (2 * n_layers + 1)],
        "all-gather world": [1, 8 * 4 * len(pairs)],
    }
    assert got == want


def test_rank_shards_are_serial_trains():
    """The traced rank's params and AdamW state have the shapes each rank
    of ``serial_train`` holds after a step at 2 × 2 (smoke Llama-3-8B)."""
    from repro_torch.training.train_loop import make_train_step
    cfg = B.get_smoke_config("llama3_8b")
    lm = LM(cfg)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def rank(mesh):
        specs = lm.train_specs(mesh)
        params = lm.init_fp(seed=0, device="cpu", mesh=mesh)
        state = OPT.adamw_init(params)
        params, state, _ = make_train_step(
            lm, OPT.AdamWConfig(), mesh=mesh, specs=specs)(params, state,
                                                          batch)
        return [tuple(t.shape) for t in OPT.tree_leaves((params, state))]

    got = PM.serial_train(rank, 2, 2, timeout_s=120)
    pmesh = PM.planning_mesh({"data": 2, "model": 2})
    cell = SP.build_cell("llama3_8b", "train_4k", pmesh, cfg=cfg,
                         shape=B.ShapeConfig("train_4k", 32, 4, "train"))
    args = SP.rank_args(cell, pmesh)
    want = [tuple(t.shape) for t in OPT.tree_leaves((args["params"],
                                                     args["opt_state"]))]
    assert all(g == want for g in got)


# ------------------------------------------------------------ MoE

def _dispatch_bincount(gate_idx, num_experts, cap):
    """The dispatch as it was, counting with ``bincount``."""
    t, k = gate_idx.shape
    flat_e = gate_idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k) - starts[sorted_e]
    keep = pos < cap
    return order, keep, torch.where(keep, sorted_e * cap + pos,
                                    num_experts * cap)


@pytest.mark.parametrize("seed", range(4))
def test_expert_counts_are_bincounts(seed):
    gen = torch.Generator().manual_seed(seed)
    e, k = (8, 64, 128, 5)[seed], (2, 6, 8, 3)[seed]
    t = (64, 240, 1000, 7)[seed]
    idx = torch.stack([torch.randperm(e, generator=gen)[:k]
                       for _ in range(t)])
    if seed == 1:               # skewed: most pairs to a few experts
        idx = torch.where(torch.rand(idx.shape, generator=gen) < 0.8,
                          idx % 3, idx)
    for cap in (4, max(int(1.25 * t * k / e), 4)):
        for a, b in zip(MLP.moe_dispatch(idx, e, cap),
                        _dispatch_bincount(idx, e, cap)):
            assert torch.equal(a, b)
    order, keep, slot = MLP.moe_dispatch(idx.to("meta"), e, 4)
    assert slot.shape == (t * k,)


# ------------------------------------------------------------ the CLI

def test_dryrun_smoke_subprocess(tmp_path):
    """The reference smoke test's cells: the smoke Llama-3-8B, ``train``
    (64 × 8) and ``decode`` (128 × 8) on a 4 × 2 mesh, through the
    port's CLI: exit 0, one JSON record a cell, the train rank traced,
    the decode cell not, with null rank figures."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3_8b", "--smoke", "--mesh", "4x2", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    recs = {}
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        with open(tmp_path / f"llama3_8b_{shape_name}_4x2_split.json") as f:
            recs[shape_name] = json.load(f)
        assert recs[shape_name]["status"] == "ok"
        assert recs[shape_name]["flops_global"] > 0
        assert recs[shape_name]["memory"]["argument_bytes"] > 0
    train, dec = recs["train_4k"], recs["decode_32k"]
    assert train["traced"] and train["flops"] > 0
    assert train["memory"]["temp_bytes"] > 0
    assert train["collectives"]["counts"]["all-gather"] > 0
    assert not dec["traced"] and "item 24" in dec["trace_refused"]
    assert dec["flops"] is None and dec["collectives"] is None
    assert dec["memory"]["temp_bytes"] is None
    assert set(dec["argument_bytes_by"]) == {"params", "cache", "batch"}
    assert len(out.stdout.strip().splitlines()) == 4
