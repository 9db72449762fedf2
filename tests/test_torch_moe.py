"""The MoE family of the port against the reference (CPU, plain kernel
versions): the two MoE configurations, the expert stacks' quantization,
QK-norm, the expert-batched W4Ax GEMM, and ``moe_apply`` with its router.

Exactness. The router's softmax, its top-k and renormalisation, the
capacity dispatch and the combine are held bit for bit: the port keeps
XLA's f32 formulas on the CPU (its ``exp``, its flush of subnormals, its
row-sum order, ``lax.top_k``'s order among ties, ``segment_sum``'s order).
Two things differ in f32 summation order alone, and are held to stated
tolerances: the bf16 router matmul (XLA's and PyTorch's CPU matmuls sum
the products in different orders; at d_model 2,048 20 of 65,536 logits
land one bf16 step apart) and the plain W4Ax GEMM (the
reference's three-operand einsum against the port's sequential block
sum, within 1e-5·max|ref|; a 1-ulp f32 difference can move a bf16 output
by one step of itself). So ``gate_idx`` and the drop mask must be equal
wherever the router logits are; the planted-tie cases put the router on
a coarse grid where the f32 sums are exact in any order, so there the
logits, and everything routed from them, must be equal outright.
"""
import contextlib
import dataclasses
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import qlinear as JQL
from repro.layers import attention as JATT
from repro.layers import common as JC
from repro.layers import mlp as JMLP
from repro.models.lm import LM as JLM
from repro.launch import serve as JSERVE
from repro.models.lm import QuantConfig as JQuantConfig
from repro_torch.configs import base as B
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import axes_from_jax, params_from_jax, to_torch
from repro_torch.core import qlinear as QL
from repro_torch.core import quantizer as Q
from repro_torch.kernels import _build
from repro_torch.kernels import act_quant as AQ
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import w4ax_matmul as WK
from repro_torch.launch import serve as SERVE
from repro_torch.layers import attention as ATT
from repro_torch.layers import mlp as MLP
from repro_torch.models.lm import LM, QuantConfig

MOE_IDS = ["moonshot_v1_16b_a3b", "qwen3_moe_235b_a22b"]
# moe_apply's test model: every expert projection and the shared expert's
# run W4A4 and W4A8 (K = 640 is 5 blocks: 4 INT4 + 1 INT8)
DIMS = dict(name="moe-apply", family="moe", num_layers=1, d_model=640,
            num_heads=5, num_kv_heads=5, head_dim=128, d_ff=640,
            vocab_size=512, num_experts=8, num_experts_per_tok=2,
            num_shared_experts=1, moe_d_ff=640)
T = 64                       # tokens of every moe_apply case (one shape)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes under the driver's parallel workers: PyTorch's
    default intra-op threads cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", MOE_IDS)
def test_config_matches_reference(arch, smoke):
    """Every field the port keeps equals the reference's, every other is
    at the reference's default, and the registry has the id."""
    get, jget = ((B.get_smoke_config, JB.get_smoke_config) if smoke
                 else (B.get_config, JB.get_config))
    cfg, jcfg = get(arch), jget(arch)
    kept = {f.name for f in dataclasses.fields(ModelConfig)}
    for f in dataclasses.fields(JModelConfig):
        if f.name in kept:
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        else:
            assert getattr(jcfg, f.name) == f.default, f.name
    assert arch in B.ARCH_IDS and cfg.family == "moe"


@pytest.mark.parametrize("arch,fraction,blocks", [
    ("qwen3_moe_235b_a22b", 0.875, {4096: (28, 4), 1536: (10, 2)}),
    ("moonshot_v1_16b_a3b", 0.875, {2048: (14, 2), 1408: (10, 1),
                                    2816: (19, 3)})])
def test_int4_share_rounds_half_to_even(arch, fraction, blocks):
    """``qlinear_spec`` rounds the INT4 share as the reference's Python
    ``round``: 0.875 · 12 = 10.5 → 10 (Qwen3-MoE's expert down
    projection), and Moonlight's shared down (2,816 channels) 19 + 3."""
    quant = QuantConfig(int4_fraction=fraction)
    for k, (nb4, nb8) in blocks.items():
        spec = QL.qlinear_spec({"w_packed": torch.zeros((k // 2, 8),
                                                        dtype=torch.uint8)},
                               quant)
        assert (spec.k4 // 128, spec.k8 // 128) == (nb4, nb8), k
    cfg = B.get_config(arch)
    assert cfg.moe_d_ff in blocks and cfg.d_model in blocks


# ------------------------------------------------- model and conversion

@pytest.mark.parametrize("arch", MOE_IDS)
def test_params_and_axes_match_reference_tree(arch):
    """The port's random smoke model has the reference's tree: the same
    leaves with the same shapes and dtypes after quantization (the router
    f32, expert stacks ``[E, K/2, N]``), and ``LM.axes`` gives the
    reference's ``qaxes`` as ``convert.axes_from_jax`` carries them."""
    jcfg, cfg = JB.get_smoke_config(arch), B.get_smoke_config(arch)
    jlm = JLM(jcfg, quant=JQuantConfig(impl="ref"))
    qp, qa = jlm.quantize(*jlm.init(jax.random.PRNGKey(0)))
    conv = params_from_jax(jax.tree.map(np.asarray, qp), device="cpu")
    mine = LM(cfg).init(seed=0, device="cpu")
    def flat(tree):
        return {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
                for p, v in jax.tree_util.tree_leaves_with_path(tree)}

    assert flat(mine) == flat(conv)
    assert LM(cfg).axes(mine) == axes_from_jax(jax.tree.map(
        tuple, qa, is_leaf=lambda x: isinstance(x, tuple)), cfg.num_layers)
    assert mine["blocks"][0]["moe"]["router"]["w"].dtype == torch.float32


def test_expert_init_scale_is_the_references():
    """``dense_init`` takes an ``[E, K, N]`` stack's first dimension as
    fan-in: the expert stacks' spread is 1/√E-scaled, the router's and
    the shared expert's 1/√d. The port's f32 block has the reference's
    spreads (its numbers come from another generator)."""
    cfg = dataclasses.replace(B.get_smoke_config("moonshot_v1_16b_a3b"),
                              d_model=256, moe_d_ff=256)
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    jp, _ = JLM(jcfg).init(jax.random.PRNGKey(3))
    jmoe = jax.tree.map(lambda a: np.asarray(a[0]), jp["blocks"])["moe"]
    mine = LM(cfg).init_block(torch.Generator().manual_seed(3), "cpu")["moe"]
    for path in (("w_up",), ("w_down",), ("router",), ("shared", "w_gate")):
        j, t = jmoe, mine
        for key in path:
            j, t = j[key], t[key]
        sj, st = float(np.std(j["w"])), float(t["w"].std())
        assert abs(st - sj) <= 0.05 * sj, (path, st, sj)
    assert float(np.std(jmoe["w_up"]["w"])) > 5 * float(
        np.std(jmoe["router"]["w"]))


@pytest.mark.parametrize("e,k,n", [(3, 256, 64), (2, 1536, 32)])
def test_expert_stack_quantization_byte_exact(e, k, n):
    """``quantize_weight_int4`` on ``[E, K, N]`` gives every expert the
    bytes and scales the reference's ``LM.quantize`` gives it (its
    ``vmap`` over the stack)."""
    w = (np.random.default_rng(k).normal(size=(e, k, n)) * 0.05).astype(
        np.float32)
    jcfg = JModelConfig(**{**DIMS, "d_model": k, "moe_d_ff": n,
                           "num_experts": e})
    tree = {"blocks": {"moe": {"w_up": {"w": jnp.asarray(w[None])}}}}
    axes = {"blocks": {"moe": {"w_up": {"w": ("layers", "experts", "embed",
                                              "mlp")}}}}
    qp, _ = JLM(jcfg, quant=JQuantConfig()).quantize(tree, axes)
    got = Q.quantize_weight_int4(torch.from_numpy(w))
    want = qp["blocks"]["moe"]["w_up"]
    for mine, key in zip(got, ("w_packed", "w_scale")):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(want[key][0]))
    assert got[0].shape == (e, k // 2, n) and got[1].shape == (e, k // 128, n)
    deq = Q.dequantize_weight_int4(*got)
    for i in range(e):
        assert torch.equal(deq[i], Q.dequantize_weight_int4(got[0][i],
                                                            got[1][i]))


def test_project_qkv_qk_norm_matches_reference():
    """QK-norm: q and k RMS-normalized over head_dim (seeded non-unit
    scales) after the projections and before RoPE, GQA 8/4 heads × 128;
    within one bf16 step of each output's magnitude (the GEMMs' f32 order
    may move a bf16 output by one ulp, and an act-quant code with it)."""
    dims = dict(DIMS, d_model=1024, num_heads=8, num_kv_heads=4,
                qk_norm=True, rope_theta=1_000_000.0)
    jcfg, cfg = JModelConfig(**dims), ModelConfig(**dims)
    jlm = JLM(jcfg, quant=JQuantConfig(impl="ref"))
    fp, axes = JC.split_annotations(JATT.init_attention(jax.random.PRNGKey(1),
                                                        jcfg))
    attn = dict(jlm.quantize({"attn": fp}, {"attn": axes})[0]["attn"])
    rng = np.random.default_rng(5)
    for name in ("q_norm", "k_norm"):
        attn[name] = {"scale": jnp.asarray(
            rng.uniform(0.5, 1.5, 128).astype(np.float32))}
    tattn = params_from_jax({"blocks": jax.tree.map(
        lambda a: np.asarray(a)[None], attn)}, device="cpu")["blocks"][0]
    assert set(tattn) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    x = jnp.asarray(rng.normal(size=(1, 48, 1024)), jnp.bfloat16)
    pos = np.arange(48)[None]
    with jlm._ctx():
        outs_j = JATT._project_qkv(attn, jcfg, x, x, jnp.asarray(pos),
                                   jnp.asarray(pos))
    outs_t = ATT.project_qkv(tattn, cfg, to_torch(np.asarray(x), "cpu"),
                             torch.from_numpy(pos), QuantConfig(impl="ref"))
    off = ATT.project_qkv(tattn, dataclasses.replace(cfg, qk_norm=False),
                          to_torch(np.asarray(x), "cpu"),
                          torch.from_numpy(pos), QuantConfig(impl="ref"))
    for oj, ot, o0 in zip(outs_j, outs_t, off):
        oj = np.asarray(oj.astype(jnp.float32))
        assert ot.dtype == torch.bfloat16 and ot.shape == oj.shape
        assert _rel_err(ot.float().numpy(), oj) <= 1e-2
    assert not torch.equal(outs_t[0], off[0])      # the norm did something
    assert torch.equal(outs_t[2], off[2])          # v is not normalized


# ------------------------------------------- XLA's f32 formulas, bit for bit

def _f32_sample():
    rng = np.random.default_rng(0)
    return np.concatenate([
        (rng.normal(size=200_000) * 4).astype(np.float32),
        np.linspace(-200, 200, 200_001, dtype=np.float32),
        (rng.normal(size=20_000) * 1e-37).astype(np.float32),   # subnormals
        np.array([0.0, -0.0, 88.72, 88.8, 88.9, -87.3, -87.8, -87.9, -103.0,
                  np.inf, -np.inf], np.float32)])


def test_exp_and_silu_are_xlas_bit_for_bit():
    """``exp_xla`` and ``silu_f32`` equal ``jnp.exp`` and ``jax.nn.silu``
    on 420,012 f32 arguments (normal, wide, subnormal, the clamp edges,
    ±inf), and the expert activation ``silu(gate)·up`` rounded to bf16
    equals the reference's on every pair of them cast to bf16 (bit for
    bit, NaN where the reference has NaN)."""
    x = _f32_sample()
    t = torch.from_numpy(x)
    for fn, jfn in ((MLP.exp_xla, jnp.exp), (MLP.silu_f32, jax.nn.silu)):
        np.testing.assert_array_equal(fn(t).numpy(),
                                      np.asarray(jfn(jnp.asarray(x))))
    # PyTorch's own exp is not XLA's: it differs on 8.5 % of these
    off = (torch.exp(t).numpy() != np.asarray(jnp.exp(jnp.asarray(x))))
    assert 0.05 <= off.mean() <= 0.1, off.mean()
    g = jnp.asarray(x, jnp.bfloat16)
    u = jnp.asarray(x[::-1].copy(), jnp.bfloat16)
    want = (jax.nn.silu(g.astype(jnp.float32)) * u.astype(jnp.float32)
            ).astype(jnp.bfloat16)
    gt, ut = (to_torch(np.asarray(a), "cpu") for a in (g, u))
    got = MLP._ftz(MLP.silu_f32(gt.float()) * MLP._ftz(ut.float())).to(
        torch.bfloat16)
    want = np.asarray(want)
    nan = np.isnan(want.astype(np.float32))           # (±inf inputs)
    assert (np.isnan(got.float().numpy()) == nan).all()
    np.testing.assert_array_equal(got.view(torch.int16).numpy()[~nan],
                                  want.view(np.int16)[~nan])


@pytest.mark.parametrize("e", [8, 64, 128, 96])
def test_softmax_is_xlas_bit_for_bit(e):
    """``softmax_f32`` equals ``jax.nn.softmax`` on bf16-valued logits
    (exact ties among them) at every expert count of the configurations."""
    rng = np.random.default_rng(e)
    lg = np.asarray(jnp.asarray(rng.normal(size=(512, e)) * 2, jnp.bfloat16)
                    .astype(jnp.float32))
    np.testing.assert_array_equal(
        MLP.softmax_f32(torch.from_numpy(lg)).numpy(),
        np.asarray(jax.nn.softmax(jnp.asarray(lg), axis=-1)))


# ------------------------------------------------------------ routing

def _ref_route(params, tkn, jcfg):
    """The reference's routing lines (``repro/layers/mlp.py:83-109``) on
    its own params → numpy logits, gate_idx and keep (sorted order)."""
    t, e, k = tkn.shape[0], jcfg.num_experts, jcfg.num_experts_per_tok
    logits = JC.linear(params["router"], tkn).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    cap = max(int(jcfg.capacity_factor * t * k / e), 4)
    flat_e = gate_idx.reshape(-1)
    sorted_e = flat_e[jnp.argsort(flat_e, stable=True)]
    counts = jnp.sum(jax.nn.one_hot(flat_e, e, dtype=jnp.int32), axis=0)
    starts = jnp.cumsum(counts) - counts
    keep = (jnp.arange(t * k) - starts[sorted_e]) < cap
    return tuple(np.asarray(a) for a in (logits, gate_idx, keep))


def _route_both(router_w, x, dims):
    jcfg, cfg = JModelConfig(**dims), ModelConfig(**dims)
    xj = jnp.asarray(x, jnp.bfloat16).reshape(-1, x.shape[-1])
    lj, ij, kj = _ref_route({"router": {"w": jnp.asarray(router_w)}}, xj, jcfg)
    tkn = to_torch(np.asarray(xj), "cpu")
    tparams = {"router": {"w": torch.from_numpy(router_w)}}
    lt = torch.from_numpy(router_w).bfloat16()
    lt = (tkn @ lt).float().numpy()
    _, _, it = MLP.moe_route(tparams, tkn, cfg, QuantConfig(impl="ref"))
    _, kt, _ = MLP.moe_dispatch(it, cfg.num_experts,
                                MLP.moe_capacity(cfg, tkn.shape[0]))
    return (lj, ij, kj), (lt, it.numpy(), kt.numpy())


def test_routing_on_random_data_at_moonlight_width():
    """d_model 2,048, 64 experts, top-6, 1,024 tokens of normal data: the
    same experts in the same order on every row whose router logits agree
    bit for bit (98 %, at least 95 % asserted; the rest differ only by the
    bf16 matmul's f32 order), though 14 % of rows hold an exact tie among
    their top 7 (5–30 % asserted)."""
    rng = np.random.default_rng(8)
    dims = dict(DIMS, d_model=2048, num_experts=64, num_experts_per_tok=6)
    x = rng.normal(size=(1024, 2048)).astype(np.float32)
    w = (rng.normal(size=(2048, 64)) / np.sqrt(2048)).astype(np.float32)
    (lj, ij, _), (lt, it, _) = _route_both(w, x, dims)
    assert (lj != lt).mean() <= 1e-3              # one logit in ≥ 1,000
    same = (lj == lt).all(-1)
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_array_equal(it[same], ij[same])
    top7 = -np.sort(-lj, -1)[:, :7]
    ties = (np.diff(top7, axis=-1) == 0).any(-1).mean()
    assert 0.05 <= ties <= 0.3, ties


def _planted(x_drop: bool):
    """Router weights on a coarse grid (multiples of 1/8 against inputs in
    multiples of 1/4: every f32 sum exact in any order), experts 2, 5 and
    6 with one column (exact three-way ties, lower index first); with
    ``x_drop`` a planted channel that sends tokens 0–39 to experts 0 and
    1, past their capacity of 20. → (router w [640, 8], x [1, T, 640])."""
    rng = np.random.default_rng(9)
    w = (rng.integers(-8, 9, (640, 8)) / 8).astype(np.float32)
    w[:, 5] = w[:, 6] = w[:, 2]
    x = (rng.integers(-4, 5, (1, T, 640)) / 4).astype(np.float32)
    if x_drop:
        w[0] = (2.0, 1.5) + (0.0,) * 6
        x[0, :40, 0] = 64.0
    return w, x


def test_routing_planted_ties_and_drops():
    """On the planted router the logits are equal on both sides and tied
    three ways on every row, at the k/k+1 boundary on many: ``gate_idx``
    (lower expert first among ties) and the drop mask are equal, and with
    the planted channel at least 40 pairs are dropped."""
    w, x = _planted(False)
    (lj, ij, kj), (lt, it, kt) = _route_both(w, x[0], DIMS)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(kt, kj)
    boundary = np.take_along_axis(lj, ij, -1)[:, -1]
    rest = np.where(np.eye(8, dtype=bool)[ij].any(1), -np.inf, lj)
    assert (rest.max(-1) == boundary).sum() >= 5     # ties at the boundary
    w, x = _planted(True)
    (lj, ij, kj), (lt, it, kt) = _route_both(w, x[0], DIMS)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(kt, kj)
    assert (np.sort(ij[:40], -1) == [0, 1]).all() and (~kt).sum() >= 40


# ---------------------------------------------------------- moe_apply

@pytest.fixture(scope="module")
def moe_model():
    jcfg, cfg = JModelConfig(**DIMS), ModelConfig(**DIMS)
    jlm = JLM(jcfg, quant=JQuantConfig(impl="ref"))
    qp, _ = jlm.quantize(*jlm.init(jax.random.PRNGKey(2)))
    jmoe = jax.tree.map(lambda a: a[0], qp["blocks"])["moe"]
    return jcfg, cfg, jlm, jmoe


@pytest.mark.parametrize("case", ["ties", "drops", "drops_unshared"])
def test_moe_apply_matches_reference(moe_model, case):
    """``moe_apply`` on the same bf16 input and converted weights as the
    reference's: ``gate_idx`` and the drop mask equal (above), the output
    within 1e-2·max|out| and bit for bit on ≥ 99 % of its elements (the
    experts' W4Ax GEMMs sum in another f32 order), the aux loss within
    1e-5 of itself; with and without the shared expert."""
    jcfg, cfg, jlm, jmoe = moe_model
    w, x = _planted(case != "ties")
    jmoe = dict(jmoe, router={"w": jnp.asarray(w)})
    if case == "drops_unshared":
        jmoe.pop("shared")
        jcfg = dataclasses.replace(jcfg, num_shared_experts=0)
        cfg = dataclasses.replace(cfg, num_shared_experts=0)
    tmoe = params_from_jax({"blocks": jax.tree.map(
        lambda a: np.asarray(a)[None], jmoe)}, device="cpu")["blocks"][0]
    xj = jnp.asarray(x, jnp.bfloat16)
    with jlm._ctx():
        yj, auxj = JMLP.moe_apply(jmoe, xj, jcfg)
    counts = []
    yt, auxt = MLP.moe_apply(tmoe, to_torch(np.asarray(xj), "cpu"), cfg,
                             QuantConfig(impl="ref"), dropped=counts)
    dropped = int(sum(counts))
    yj = np.asarray(yj.astype(jnp.float32))
    keep = _ref_route(jmoe, jnp.asarray(x[0], jnp.bfloat16), jcfg)[2]
    assert dropped == (~keep).sum() and (dropped >= 40) == (case != "ties")
    assert yt.dtype == torch.bfloat16 and yt.shape == (1, T, 640)
    yt = yt.float().numpy()
    assert _rel_err(yt, yj) <= 1e-2
    assert (yt == yj).mean() >= 0.99
    assert abs(float(auxt) - float(auxj)) <= 1e-5 * abs(float(auxj))


# ---------------------------------------------- the expert-batched GEMM

@pytest.mark.parametrize("schedule", ["split", "mixed"])
@pytest.mark.parametrize("k,n", [(1536, 64), (640, 32)])
def test_expert_gemm_plain_matches_reference_vmap(k, n, schedule):
    """The dispatch on an expert stack against the reference's ``vmap`` of
    ``_dispatch_qlinear`` (``impl="ref"``) on the same f32 capacity
    buffers (zero rows included): the act-quant codes are the reference's
    per row, the f32 output within 1e-5·max|ref| (the einsum's f32
    order), and it is each expert's own plain GEMM bit for bit. K = 1,536
    is 12 blocks: 10 INT4 + 2 INT8 (half to even)."""
    rng = np.random.default_rng(k + n)
    e, c = 4, 5
    w = (rng.normal(size=(e, k, n)) * 0.05).astype(np.float32)
    x = rng.normal(size=(e, c, k)).astype(np.float32)
    x[:, -2:] = 0.0                                   # empty slots
    wp, ws = Q.quantize_weight_int4(torch.from_numpy(w))
    slot = {"w_packed": wp, "w_scale": ws}
    quant = QuantConfig(schedule=schedule, impl="ref")
    got = QL.dispatch_qlinear(slot, torch.from_numpy(x), quant)
    rt = JQL.QuantRuntime(schedule=schedule, impl="ref")
    with JQL.quant_runtime(rt):
        want = np.asarray(jax.vmap(JQL._dispatch_qlinear)(
            {"w_packed": jnp.asarray(wp.numpy()),
             "w_scale": jnp.asarray(ws.numpy())}, jnp.asarray(x)))
    assert got.dtype == torch.float32 and got.shape == (e, c, n)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    spec = QL.qlinear_spec(slot, quant)
    assert (spec.k4, spec.k8) == ((1280, 256) if k == 1536 else (512, 128))
    for i in range(e):
        one = QL.dispatch_qlinear({"w_packed": wp[i], "w_scale": ws[i]},
                                  torch.from_numpy(x[i]), quant)
        assert torch.equal(got[i], one)


PLAIN = {
    "act_quant_w4ax": lambda x, tag, stride, m, k, k4, *out: [
        t.copy_(r) for t, r in zip(out, AQ.act_quant_w4ax_ref(x, k4))],
    "w4a4_matmul_experts": lambda a, s, w, ws, out, *_: out.copy_(
        WK.w4a4_matmul_ref(a, s, w, ws)),
    "w4a8_matmul_experts": lambda a, s, w, ws, out, *_: out.copy_(
        WK.w4a8_matmul_ref(a, s, w, ws)),
    "w4ax_matmul_mixed_experts": lambda a4, s4, a8, s8, w, ws, out, *_:
        out.copy_(WK.w4ax_matmul_mixed_ref(a4, s4, a8, s8, w, ws)),
}


@pytest.mark.parametrize("schedule,want", [
    ("split", {"act_quant_w4ax": 1, "w4a4_matmul_experts": 2,
               "w4a8_matmul_experts": 2}),
    ("mixed", {"act_quant_w4ax": 1, "w4ax_matmul_mixed_experts": 2})])
def test_expert_projections_launch_once_for_all_experts(monkeypatch,
                                                        schedule, want):
    """On the kernel path (C entry points swapped for stand-ins running
    the plain versions, so the real wrappers, fallbacks and counters run
    on the CPU) gate and up of 6 experts share one act-quant launch over all
    E·C rows, and each projection is one launch per kernel of its
    schedule, whatever E; the results are the plain path's."""
    monkeypatch.setattr(_build, "call",
                        lambda lib, fn, dev, *args: PLAIN[fn](*args))
    monkeypatch.setattr(OPS, "use_kernel", lambda impl, t: True)
    monkeypatch.setattr(AQ, "_check", lambda x: None)
    monkeypatch.setattr(WK, "_check_experts", lambda a, a_s, w, w_s, nb, c: (
        a.shape[0], a.shape[1], w.shape[2], w.stride(0), w_s.stride(0)))
    for kern in OPS.KERNELS.values():
        monkeypatch.setattr(kern, "launches", 0)
    rng = np.random.default_rng(4)
    e, c, k, n = 6, 7, 1024, 64
    stacks = [dict(zip(("w_packed", "w_scale"), Q.quantize_weight_int4(
        torch.from_numpy((rng.normal(size=(e, k, n)) * .05).astype(
            np.float32))))) for _ in range(2)]
    x = torch.from_numpy(rng.normal(size=(e, c, k)).astype(np.float32))
    quant = QuantConfig(schedule=schedule, impl="cuda")
    outs = QL.qlinear_apply_many([QL.qlinear_spec(s, quant) for s in stacks],
                                 stacks, x)
    got = {name: kern.launches for name, kern in OPS.KERNELS.items()
           if kern.launches}
    assert got == want
    plain = QuantConfig(schedule=schedule, impl="ref")
    for out, s in zip(outs, stacks):
        assert torch.equal(out, QL.dispatch_qlinear(s, x, plain))


# ------------------------------------------------------------ launcher

def test_serve_cli_takes_moe_archs(capsys, monkeypatch):
    """``--arch qwen3_moe_235b_a22b --smoke`` (QK-norm, 128-way routing cut
    to 8 experts, no shared experts) through the registry: the port's
    launcher's counts equal the reference launcher's for the same flags
    (each with its own random weights, so tokens are not compared)."""
    argv = ["--arch", "qwen3_moe_235b_a22b", "--smoke", "--impl", "ref",
            "--requests", "3", "--max-new", "4", "--prompt-len", "16"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eng = SERVE.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    JSERVE.main()
    ref = capsys.readouterr().out
    pat = (r"\[done\] (\d+) requests, (\d+) tokens .*steps=(\d+), "
           r"forwards=(\d+),.*preemptions=(\d+)\)")
    got, want = (re.search(pat, o) for o in (out.getvalue(), ref))
    assert got and want and got.groups() == want.groups()
    assert got.groups()[:2] == ("3", "12")
    assert eng.cfg.family == "moe" and eng.cfg.qk_norm
    assert eng.counters()["internal_errors"] == 0
