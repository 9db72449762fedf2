"""Tensor parallelism's pieces against the reference (CPU): the sharding
rules and specs for every dense configuration, the row seam's partial
sums, the per-shard work-queue descriptors, the refusals, and the rank
processes' own failures. The engines under gloo are in
``test_torch_tp_engine.py`` (M = 2) and ``test_torch_tp_wide.py`` (M = 4).
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import _torch_durable_ranks as D
import _torch_tp_ranks as R
from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core import qlinear as JQL
from repro.core import quantizer as JQ
from repro.launch.specs import shapes_of_init
from repro.models.lm import LM as JLM
from repro.models.lm import QuantConfig as JQuantConfig
from repro.parallel import sharding as JSH
from repro.serving import kv_cache as JKVC
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.convert import axes_from_jax, params_from_jax, to_torch
from repro_torch.core import qlinear as QL
from repro_torch.launch import mesh as LM_MESH
from repro_torch.launch import serve as SERVE
from repro_torch.models.lm import ENGINE_FAMILIES, LM, QuantConfig
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.mesh import Mesh
from repro_torch.serving import kv_cache as KVC
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.recovery import RecoveryLog
from repro_torch.serving.replication import ReplicaGroup

SMOKE64 = dataclasses.replace(get_smoke_config("llama3_8b"), head_dim=64)
QC = QuantConfig(int4_fraction=1.0, impl="ref")


def reference_model(jcfg, cfg, quant):
    """The reference's seeded weights and axes, quantized by the
    reference and converted → (cfg, params, axes, quant) for the port."""
    params, axes = JLM(jcfg).init(jax.random.PRNGKey(0))
    qparams, qaxes = JLM(jcfg, quant=JQuantConfig(
        int4_fraction=quant.int4_fraction, impl="ref")).quantize(params, axes)
    tree = jax.tree.map(np.asarray, qparams)
    return (cfg, params_from_jax(tree, device="cpu"),
            axes_from_jax(qaxes, cfg.num_layers), quant)


def jmesh(m: int):
    """An abstract (1, m) mesh (``tests/launch/test_sharding.py``'s)."""
    return JMesh(np.array((jax.devices() * m)[:m]).reshape(1, m),
                 ("data", "model"))


def pmesh(m: int, data: int = 1) -> Mesh:
    return Mesh(shape={"data": data, "model": m})


# ------------------------------------------------------------- specs

def _meta(tree, drop_layer=False):
    if isinstance(tree, dict):
        return {k: _meta(v, drop_layer) for k, v in tree.items()}
    shape = tuple(tree.shape)[1 if drop_layer else 0:]
    return torch.empty(shape, device="meta")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str):
    """The reference's quantized param shapes and axes, not materialized."""
    return shapes_of_init(JLM(jget_config(arch), quant=JQuantConfig()),
                          quantized=True)


# the configurations a mesh serves (LM.axes: the dense and moe families)
MESH_ARCHS = [a for a in ARCH_IDS
              if get_config(a).family in ENGINE_FAMILIES]


@pytest.mark.parametrize("m", (2, 4, 8))
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_param_specs_equal_reference(arch, m):
    """Every dense configuration at full width: the port's axes are the
    reference's ``qaxes`` without ``"layers"``, and its SERVE_RULES specs
    the reference's (the layer axis replicated there) for every tensor."""
    qshapes, qaxes = _ref_shapes(arch)
    cfg = get_config(arch)
    tree = {k: _meta(v) for k, v in qshapes.items() if k != "blocks"}
    tree["blocks"] = [_meta(qshapes["blocks"], drop_layer=True)]
    axes = LM(cfg).axes(tree)
    assert axes == axes_from_jax(qaxes, 1)
    want = JSH.tree_pspecs(qaxes, qshapes, jmesh(m), JSH.SERVE_RULES)
    got = SH.tree_pspecs(axes, tree, pmesh(m), SH.SERVE_RULES)
    got_blocks = dict(_flat(got.pop("blocks")[0]))
    for path, spec in _flat({k: v for k, v in want.items()
                             if k != "blocks"}):
        assert dict(_flat(got))[path] == tuple(spec), path
    for path, spec in _flat(want["blocks"]):
        assert tuple(spec)[0] is None
        assert got_blocks[path] == tuple(spec)[1:], path
    # the projections this slice shards, and only those
    wq, wo = got_blocks[("attn", "wq", "w_packed")], \
        got_blocks[("attn", "wo", "w_packed")]
    if cfg.q_dim % m == 0:
        assert wq == (None, "model") and wo == ("model", None)


@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, m):
    """The paged pools shard over kv heads only, their scales to match."""
    cfg = get_config(arch)
    pool = (cfg.num_layers, 64, 16, cfg.num_kv_heads, cfg.head_dim // 2)
    scale = (cfg.num_kv_heads, 1, cfg.head_dim)
    names = {"k_pool": pool, "v_pool": pool, "k_scale": scale,
             "k_zero": scale, "v_scale": scale, "v_zero": scale}
    want = JSH.cache_pspecs(
        {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in names.items()},
        jmesh(m))
    got = SH.cache_pspecs(
        {k: torch.empty(s, device="meta") for k, s in names.items()},
        pmesh(m))
    assert got == {k: tuple(v) for k, v in want.items()}


def test_spec_for_axes_divisibility_fallback():
    """The reference's own cases (``tests/launch/test_sharding.py``)."""
    mesh = pmesh(2, data=2)
    assert SH.spec_for_axes(("heads", "mlp"), (5, 8), mesh,
                            SH.SERVE_RULES) == (None, "model")
    assert SH.spec_for_axes(("embed", "heads"), (4, 8), mesh,
                            SH.TRAIN_RULES) == ("data", "model")
    assert SH.spec_for_axes(("heads", "mlp"), (4, 8), mesh,
                            SH.SERVE_RULES) == ("model", None)


def test_sharded_init_is_the_shard_of_the_whole():
    """``LM.init(mesh=)`` draws the same blocks and keeps each rank's
    slice: the row and column slices of the whole model's tensors."""
    lm = LM(SMOKE64)
    whole = lm.init(seed=3, device="cpu")
    axes = lm.axes(whole)
    for rank in range(2):
        mesh = Mesh(shape={"data": 1, "model": 2}, model_rank=rank)
        part = lm.init(seed=3, device="cpu", mesh=mesh)
        want = SH.shard_tree(whole, SH.tree_pspecs(
            axes, whole, mesh, SH.SERVE_RULES), mesh)
        for (path, a), (_, b) in zip(_flat(want["blocks"][1]),
                                     _flat(part["blocks"][1])):
            assert torch.equal(a, b), path
        wo = part["blocks"][0]["attn"]["wo"]["w_packed"]
        assert wo.shape == (SMOKE64.q_dim // 4, SMOKE64.d_model)
        assert torch.equal(part["embed"]["table"], whole["embed"]["table"])


# ------------------------------------------------------------ the seam

def _seam_inputs(rng, k: int, n: int, t: int, m: int, frac: float,
                 exact: bool):
    """(w f32 [K, N], x bf16 [T, K]) for a row seam at ``m`` ranks. With
    ``exact`` every weight and activation block's absmax is 7 (or, in a
    shard's INT8 tail, 127) times one power of two, so every scale is that
    power of two and every block product and sum is exact in f32: any
    summation order gives the same bits. Otherwise standard normals."""
    if not exact:
        w = rng.standard_normal((k, n)) / np.sqrt(k)
        return (w.astype(np.float32),
                jnp.asarray((rng.standard_normal((t, k)) * 2)
                            .astype(np.float32)).astype(jnp.bfloat16))
    wq = rng.integers(-7, 8, (k, n))
    wq[::128] = 7 * rng.choice((-1, 1), (k // 128, n))
    xq = rng.integers(-7, 8, (t, k))
    ks, nb = k // m, k // m // 128
    nb4 = int(round(frac * nb))
    for r in range(m):              # each shard's INT8 tail blocks
        lo, hi = r * ks + nb4 * 128, (r + 1) * ks
        xq[:, lo:hi] = rng.integers(-127, 128, (t, hi - lo))
        xq[:, lo:hi:128] = 127
    xq[:, ::128] = np.where(xq[:, ::128] == 127, 127, 7)
    return ((wq * 2.0 ** -6).astype(np.float32),
            jnp.asarray((xq * 0.25).astype(np.float32)).astype(jnp.bfloat16))


def seam_cases(m: int) -> list:
    """Row-seam cases at ``m`` ranks, 8 blocks a shard: ``int4_fraction``
    1.0 and 0.875 (8+0 and 7+1 blocks), without and with a bias, on exact
    inputs (power-of-two scales, :func:`_seam_inputs`) and on normal ones
    → [((x per rank, packed shard per rank, quant), want bf16 bits)].
    Each rank's f32 partial is held here against the reference's
    ``_dispatch_qlinear(shard, x, out_dtype=f32)``: bit for bit on the
    exact inputs; on normal ones within 1e-6 of max|partial|, since the
    reference's plain GEMM sums the blocks with a three-operand einsum in
    XLA's order (see ROADMAP's caveats). The want is the partials summed
    in rank order, the bias added once, rounded to bf16 once: the
    reference's on the exact inputs, the port's own on normal ones."""
    k, n, t = m * 1024, 256, 12
    rng = np.random.default_rng(40 + m)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    ks = k // m
    cases = []
    for exact in (True, False):
        for frac in (1.0, 0.875):
            quant = QuantConfig(int4_fraction=frac, impl="ref")
            w, x = _seam_inputs(rng, k, n, t, m, frac, exact)
            qt = JQ.quantize_weight_int4(jnp.asarray(w), group_size=128)
            packed, scale = np.asarray(qt.data), np.asarray(qt.scale)
            xs, shards, ref, mine = [], [], [], []
            for r in range(m):
                jp = {"w_packed": jnp.asarray(
                          packed[r * ks // 2:(r + 1) * ks // 2]),
                      "w_scale": jnp.asarray(
                          scale[r * ks // 128:(r + 1) * ks // 128])}
                xr = x[:, r * ks:(r + 1) * ks]
                with JQL.quant_runtime(JQL.QuantRuntime(int4_fraction=frac,
                                                        impl="ref")):
                    ref.append(np.asarray(JQL._dispatch_qlinear(
                        jp, xr, out_dtype=jnp.float32)))
                shards.append({key: to_torch(np.asarray(v), "cpu")
                               for key, v in jp.items()})
                xs.append(to_torch(np.asarray(xr), "cpu"))
                mine.append(QL.dispatch_qlinear(
                    shards[r], xs[r], quant, out_dtype=torch.float32).numpy())
                if exact:
                    np.testing.assert_array_equal(mine[r], ref[r])
                else:
                    np.testing.assert_allclose(
                        mine[r], ref[r], rtol=0,
                        atol=1e-6 * np.abs(ref[r]).max())
            for bias in (False, True):
                acc = (ref if exact else mine)[0]
                for part in (ref if exact else mine)[1:]:
                    acc = acc + part
                if bias:
                    acc = acc + b
                want = np.asarray(jnp.asarray(acc).astype(jnp.bfloat16)
                                  ).view(np.int16)
                with_b = [dict(sh, b=torch.from_numpy(b)) if bias else sh
                          for sh in shards]
                cases.append(((xs, with_b, quant), want))
    return cases


@pytest.mark.parametrize("m", (2, 4))
def test_row_seam_partials_equal_reference(m):
    """Each rank's f32 partial against the reference's (inside
    ``seam_cases``); at 0.875 a shard of 8 blocks rounds its own split
    (7 INT4 + 1 INT8), as ``shard_map`` does, where one device would split
    the whole K."""
    cases = seam_cases(m)
    assert len(cases) == 8
    spec = QL.qlinear_spec(cases[2][0][1][0], cases[2][0][2])
    assert (spec.k, spec.k4) == (1024, 896)


# ------------------------------------------------------- descriptors

@pytest.mark.parametrize("m", (2, 4))
def test_local_descriptors_equal_reference(m):
    """One descriptor set at the local head count, as the reference's
    ``work_queue_np(num_kv_heads=, pad_row=)`` builds it for every
    shard."""
    jcfg = dataclasses.replace(jget_smoke_config("llama3_8b"), head_dim=64,
                               num_heads=8, num_kv_heads=4)
    cfg = dataclasses.replace(SMOKE64, num_heads=8, num_kv_heads=4)
    jc = JKVC.PagedKV4Cache(jcfg, JKVC.PagedKV4Config(
        num_pages=64, page_size=8, max_seqs=8, max_pages_per_seq=16), 2)
    pc = KVC.PagedKV4Cache(cfg, KVC.PagedKV4Config(
        num_pages=64, page_size=8, max_seqs=8, max_pages_per_seq=16), 2,
        device="cpu", mesh=pmesh(m))
    for c in (jc, pc):
        for slot, n in enumerate((13, 30, 5)):
            assert c.allocate_seq(slot, n)
    hl, nb = 4 // m, 4
    want = jc.work_queue_np([0, 1, 2], [12, 26, 0], [1, 4, 5],
                            pad_row=nb * hl, num_kv_heads=hl)
    got = pc.work_queue_np([0, 1, 2], [12, 26, 0], [1, 4, 5],
                           pad_row=nb * hl, num_kv_heads=hl)
    np.testing.assert_array_equal(got, want)
    assert pc.k_pool.shape[3] == hl and pc.k_scale.shape[0] == hl
    # the byte cap counts every head, on every rank
    assert pc.page_bytes == jc.page_bytes


# ----------------------------------------------------------- refusals

@pytest.fixture(scope="module")
def smoke_params():
    return LM(SMOKE64).init(seed=0, device="cpu")


def _tp_engine(cfg, params, mesh, axes="auto", **ecfg):
    if axes == "auto":
        axes = LM(cfg).axes(params)
    return Engine(cfg, params, QC, EngineConfig(
        max_batch=2, num_pages=32, page_size=8, **ecfg), device="cpu",
        mesh=mesh, param_axes=axes)


def test_refuses_missing_param_axes(smoke_params):
    with pytest.raises(ValueError, match="param_axes"):
        _tp_engine(SMOKE64, smoke_params, pmesh(2), axes=None)


def test_refuses_split_step(smoke_params):
    with pytest.raises(ValueError, match="unified"):
        _tp_engine(SMOKE64, smoke_params, pmesh(2), unified_step=False)


def test_refuses_non_dense_family(smoke_params):
    with pytest.raises(NotImplementedError, match="dense"):
        _tp_engine(dataclasses.replace(SMOKE64, family="moe"),
                   smoke_params, pmesh(2), LM(SMOKE64).axes(smoke_params))


def test_refuses_indivisible_heads(smoke_params):
    bad = dataclasses.replace(SMOKE64, num_heads=3, num_kv_heads=3)
    with pytest.raises(ValueError, match="num_kv_heads|num_heads"):
        _tp_engine(bad, smoke_params, pmesh(2))


def test_refuses_partial_quant_blocks():
    """The smoke config's q_dim of 128 is one quant block: no row shard."""
    cfg = get_smoke_config("llama3_8b")
    with pytest.raises(ValueError, match="quant blocks"):
        _tp_engine(cfg, LM(cfg).init(seed=0, device="cpu"), pmesh(2))


def test_refuses_data_axis(smoke_params):
    """Serving refuses a data axis above 1 (ROADMAP item 11);
    ``make_local_mesh`` itself takes one now (training's), and only
    refuses being called outside a rank."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _tp_engine(SMOKE64, smoke_params, pmesh(2, data=2))
    with pytest.raises(RuntimeError, match="inside a rank"):
        LM_MESH.make_local_mesh(2, 1)


def test_refuses_out_of_slice_combinations(smoke_params):
    """Once refused, now ported: a RecoveryLog over a TP engine and a
    replica group over per-replica meshes, built in two gloo ranks (two
    meshes of one rank each, through the real process groups), serve the
    one-device log's and group's tokens."""
    model = (SMOKE64, smoke_params, LM(SMOKE64).axes(smoke_params), QC)
    got = LM_MESH.spawn(D.out_of_slice_calls, 2, (model,), threads=1,
                        timeout_s=120.0)
    eng = R._engine(model, None)
    log = RecoveryLog(eng, snapshot_every=2)
    D._submit(eng, SMOKE64.vocab_size)
    want_log = D._streams(log.run())["tokens"]
    group = ReplicaGroup(SMOKE64, smoke_params, QC, EngineConfig(**R.ENGINE),
                         replicas=2, device="cpu")
    rids = [group.submit(p, SamplingParams(max_new_tokens=D.MAX_NEW))
            for p in R.prompts(SMOKE64.vocab_size, (10, 15, 7), seed=19)]
    group.run()
    assert len(want_log) == 3 and group.failovers == 0
    for r in got:
        assert r["log"] == want_log
        assert r["group"] == {i: group.tokens_for(i) for i in rids}


def _counts(text: str) -> list:
    """The summary's count lines, without times and rates."""
    return [re.sub(r" in [\d.]+s → [\d.]+ tok/s", "", ln)
            for ln in text.splitlines()
            if ln.startswith(("[done]", "[group]", "[robust]", "[death]",
                              "[recovery]", "[states]", "  req "))]


@pytest.mark.parametrize("flags", [
    ["--mesh", "2x1"], ["--mesh", "1x2", "--replicas", "2"],
    ["--mesh", "1x2", "--snapshot-every", "2"]],
    ids=["data_axis", "replicas", "recovery"])
def test_launcher_refuses_out_of_slice(flags, capfd):
    """A data axis above 1 is not ported and raises naming ROADMAP. The
    two combinations once refused with it now serve: the replica group
    over per-replica meshes and the RecoveryLog over the mesh exit with
    the single-device launcher's counts."""
    argv = ["--arch", "llama3_8b", "--smoke", "--head-dim", "64",
            "--device", "cpu"]
    if flags[1] == "2x1":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SERVE.main(argv + flags)
        return
    SERVE.main(argv + flags[2:])
    single = capfd.readouterr().out
    SERVE.main(argv + flags)
    meshed = capfd.readouterr().out
    want = _counts(single)
    assert any(ln.startswith("[group]" if "--replicas" in flags
                             else "[recovery]") for ln in want), single
    assert _counts(meshed) == want


def test_no_mesh_larger_than_the_cards():
    """The CPU has no card: a CUDA mesh of any size raises, never
    clamps, and so does a mesh built outside a rank."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="no mesh is clamped"):
        LM_MESH.check_cards(n + 1, "cuda")
    with pytest.raises(ValueError, match="no mesh is clamped"):
        LM_MESH.spawn(R.sleep, n + 1, (0,), device_type="cuda")
    with pytest.raises(RuntimeError, match="inside a rank"):
        LM_MESH.make_local_mesh(1, 2)


def test_parse_mesh_arg():
    assert LM_MESH.parse_mesh_arg("1x4") == (1, 4)
    for bad in ("4", "1x0", "ax2"):
        with pytest.raises(ValueError, match="--mesh"):
            LM_MESH.parse_mesh_arg(bad)


# ------------------------------------------------------ rank failures

def test_a_failing_rank_fails_the_group():
    """Rank 1 raises while rank 0 waits for it: the spawn raises rank 1's
    error and stops rank 0."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        LM_MESH.spawn(R.fail_on_rank_1, 2, threads=1, timeout_s=60.0)


def test_a_rank_local_error_fails_the_group(smoke_params):
    """Under a mesh an error raised on one rank alone inside a forward is
    not swallowed by the forward's quarantine or the step's backstop (the
    other rank waits in that forward's seams): the spawn raises it."""
    model = (SMOKE64, smoke_params, LM(SMOKE64).axes(smoke_params), QC)
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*"
                                           "fails on purpose"):
        LM_MESH.spawn(R.forward_fails_on_rank_1, 2, (model,), threads=1,
                      timeout_s=60.0, collective_timeout_s=30.0)


def test_a_hung_rank_times_out():
    with pytest.raises(TimeoutError, match="did not finish"):
        LM_MESH.spawn(R.sleep, 1, (60,), threads=1, timeout_s=3.0)


def test_world_size_one_is_the_unsharded_engine():
    """Through the real process group and seams, a (1, 1) mesh serves the
    single-device engine's tokens and counts."""
    jcfg = dataclasses.replace(jget_smoke_config("llama3_8b"), head_dim=64)
    model = reference_model(jcfg, SMOKE64, QuantConfig(impl="ref"))
    one = R.run_workloads(model, None, names=("mixed",))
    (got,) = LM_MESH.spawn(R.rank_main, 1, (model, None, [], ("mixed",)),
                           threads=1, timeout_s=120.0)
    assert got["mixed"]["tokens"] == one["mixed"]["tokens"]
    assert got["mixed"]["per_shard"] == [one["mixed"]["attn_work_items"]]
    assert got["foreign"] == []
