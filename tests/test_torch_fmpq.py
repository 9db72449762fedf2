"""FMPQ and the quantizer functions it needs, in the port and in the JAX
reference, on the same numpy inputs (CPU, plain kernel versions).

Byte for byte: every quantizer function the slice adds (scales, zeros,
codes, nibbles), every FMPQ function (perms, ``block_bits``,
``num_int4_blocks``), planted ties in absmax (the stable order), the
``max_int8_fraction`` cap, a K with no outlier and one whose every block
is INT8. The planned projection (``quantize_linear`` +
``qlinear_apply``) against the reference's within 1e-6·max|ref| (the
reference's plain GEMM sums its block products in XLA's order, ROADMAP
caveats). The dispatcher's ``perm`` path, against the reference's
``_dispatch_qlinear``, and the shared act-quant of projections of one
input, which two permutations must not share.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fmpq as JF
from repro.core import qlinear as JQL
from repro.core import quantizer as JQ
from repro_torch.configs import get_smoke_config
from repro_torch.convert import plan_from_jax
from repro_torch.core import fmpq as F
from repro_torch.core import qlinear as QL
from repro_torch.core import quantizer as Q
from repro_torch.layers import common as C
from repro_torch.models.lm import LM, QuantConfig
from repro_torch.parallel.mesh import Mesh
from repro_torch.serving.engine import Engine, EngineConfig


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got.numpy(), want)


def _val(a):
    return a.value if hasattr(a, "value") else a


def _outlier_acts(rng, m, k, n_out, mag):
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[:, rng.choice(k, n_out, replace=False)] *= mag
    return x


# ------------------------------------------------------------ quantizer

@pytest.mark.parametrize("clip", [1.0, 0.9])
@pytest.mark.parametrize("bits", [4, 8])
def test_absmax_scale_and_act_groupwise_clip(clip, bits):
    rng = np.random.default_rng(bits)
    x = (rng.normal(size=(6, 384)) * 3).astype(np.float32)
    x[-1, :128] = 0.0
    xb = x.reshape(6, 3, 128)
    _eq(Q.absmax_scale(_t(xb), 2, bits, clip),
        JQ.absmax_scale(jnp.asarray(xb), 2, bits, clip))
    qj, sj = JQ.quantize_act_groupwise(jnp.asarray(x), 128, bits, clip)
    qt, st = Q.quantize_act_groupwise(_t(x), 128, bits, clip)
    _eq(qt, qj)
    _eq(st, sj)


@pytest.mark.parametrize("group", [-1, 128])
@pytest.mark.parametrize("clip", [1.0, 0.9])
def test_quantize_weight_int4_group_and_clip(group, clip):
    rng = np.random.default_rng(group + 7)
    w = (rng.normal(size=(384, 72)) * 0.05).astype(np.float32)
    qt = JQ.quantize_weight_int4(jnp.asarray(w), group, clip)
    packed, scale = Q.quantize_weight_int4(_t(w), group, clip)
    _eq(packed, qt.data)
    _eq(scale, qt.scale)
    _eq(Q.dequantize_weight_int4(packed, scale, group),
        JQ.dequantize_weight_int4(qt, group))


def test_asym_scale_zero_and_dequantize():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 33, 16)) * 2 + 0.5).astype(np.float32)
    x[0, :, 0] = 1.25               # a flat channel: scale floors at 1e-8
    for axis in (-2, -1):
        sj, zj = JQ.asym_scale_zero(jnp.asarray(x), axis, 4)
        st, zt = Q.asym_scale_zero(_t(x), axis, 4)
        _eq(st, sj)
        _eq(zt, zj)
    q4 = rng.integers(-8, 8, (5, 256)).astype(np.int8)
    q8 = rng.integers(-128, 128, (5, 256)).astype(np.int8)
    s = rng.uniform(0.01, 2, (5, 1)).astype(np.float32)
    _eq(Q.dequantize_int4(_t(q4), _t(s)),
        JQ.dequantize_int4(jnp.asarray(q4), jnp.asarray(s)))
    _eq(Q.dequantize_int8(_t(q8), _t(s)),
        JQ.dequantize_int8(jnp.asarray(q8), jnp.asarray(s)))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_pack_unpack_int4(axis):
    rng = np.random.default_rng(axis + 5)
    q = rng.integers(-8, 8, (6, 10, 8)).astype(np.int8)
    pj = JQ.pack_int4(jnp.asarray(q), axis)
    pt = Q.pack_int4(_t(q), axis)
    _eq(pt, pj)
    _eq(Q.unpack_int4(pt, axis), JQ.unpack_int4(pj, axis))
    _eq(Q.unpack_int4_biased(pt, axis), JQ.unpack_int4_biased(pj, axis))
    with pytest.raises(ValueError, match="even"):
        Q.pack_int4(_t(q[:, :9]), 1)


def test_quantize_kv_channelwise():
    rng = np.random.default_rng(11)
    kv = (rng.normal(size=(2, 3, 37, 128)) * 4).astype(np.float32)
    kv[0, 0, :, 5] = -2.0           # a constant channel
    pj, sj, zj = JQ.quantize_kv_channelwise(jnp.asarray(kv))
    pt, st, zt = Q.quantize_kv_channelwise(_t(kv))
    _eq(pt, pj)
    _eq(st, sj)
    _eq(zt, zj)
    _eq(Q.dequantize_kv_channelwise(pt, st, zt),
        JQ.dequantize_kv_channelwise(pj, sj, zj))


# ---------------------------------------------------------------- FMPQ

def _plan_cases():
    rng = np.random.default_rng(0)
    cases = {}
    a = rng.uniform(0.5, 1.5, 1024)
    a[rng.choice(1024, 30, replace=False)] *= 100.0
    cases["30 outliers"] = (a, JF.FMPQConfig())
    t = rng.choice([0.5, 1.0, 1.5], 512).astype(np.float64)   # ties
    t[rng.choice(512, 20, replace=False)] = 50.0             # tied outliers
    cases["ties"] = (t, JF.FMPQConfig())
    c = rng.uniform(0.5, 1.5, 1024)
    c[rng.choice(1024, 200, replace=False)] *= rng.uniform(20, 90, 200)
    cases["cap"] = (c, JF.FMPQConfig(max_int8_fraction=0.05))
    cases["no outlier"] = (rng.uniform(0.5, 1.5, 768), JF.FMPQConfig())
    cases["every block int8"] = (rng.uniform(0.5, 1.5, 384),
                                 JF.FMPQConfig(outlier_threshold=0.3))
    z = np.abs(rng.normal(size=256)).astype(np.float32)
    z[:140] = 0.0                   # median 0: the mean stands in
    cases["zero median"] = (z, JF.FMPQConfig())
    return cases


PLAN_CASES = _plan_cases()


def _port_config(cfg: JF.FMPQConfig) -> F.FMPQConfig:
    return F.FMPQConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan_fmpq_byte_exact(name):
    absmax, jcfg = PLAN_CASES[name]
    cfg = _port_config(jcfg)
    jmask = JF.identify_outlier_channels(absmax, jcfg.outlier_threshold)
    mask = F.identify_outlier_channels(absmax, cfg.outlier_threshold)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(F.make_permutation(mask, absmax),
                                  JF.make_permutation(jmask, absmax))
    jp, tp = JF.plan_fmpq(absmax, jcfg), F.plan_fmpq(absmax, cfg)
    for f in ("perm", "inv_perm", "block_bits"):
        got, want = getattr(tp, f), getattr(jp, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert tp.num_int4_blocks == jp.num_int4_blocks
    assert tp.k4 == jp.k4 and tp.k == jp.k
    assert F.int4_block_fraction(tp) == JF.int4_block_fraction(jp)
    np.testing.assert_array_equal(
        F.assign_block_precision(mask[tp.perm], 128),
        JF.assign_block_precision(jmask[jp.perm], 128))
    conv = plan_from_jax(jp)
    assert all(np.array_equal(getattr(conv, f), getattr(tp, f))
               for f in ("perm", "inv_perm", "block_bits"))
    assert conv.num_int4_blocks == tp.num_int4_blocks
    print(f"{name}: int4 fraction {tp.int4_fraction:.4f}")
    if name == "no outlier":
        assert tp.num_int4_blocks == tp.num_blocks
    if name == "every block int8":
        assert tp.num_int4_blocks == 0
    if name == "cap":
        assert (tp.block_bits == 8).sum() == 1     # 51 channels: one block
    if name == "ties":
        # among equal absmax the lower channel comes first
        normal = tp.perm[:tp.k - 20]
        vals = absmax[normal]
        same = vals[1:] == vals[:-1]
        assert (normal[1:][same] > normal[:-1][same]).all()


def test_collect_channel_stats():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 7, 256)).astype(np.float32)
    _eq(F.collect_channel_stats(_t(x)), JF.collect_channel_stats(
        jnp.asarray(x)))


def test_apply_plan_to_weight_and_activation():
    rng = np.random.default_rng(5)
    x = _outlier_acts(rng, 64, 512, 12, 40.0)
    w = (rng.normal(size=(512, 96)) * 0.05).astype(np.float32)
    absmax = np.abs(x).max(0)
    for jcfg in (JF.FMPQConfig(),
                 JF.FMPQConfig(act_clip_ratio=0.9, weight_clip_ratio=0.85)):
        jp, cfg = JF.plan_fmpq(absmax, jcfg), _port_config(jcfg)
        tp = F.plan_fmpq(absmax, cfg)
        assert 0 < tp.num_int4_blocks < tp.num_blocks
        qt = JF.apply_fmpq_to_weight(jnp.asarray(w), jp, jcfg)
        packed, scale = F.apply_fmpq_to_weight(_t(w), tp, cfg)
        _eq(packed, qt.data)
        _eq(scale, qt.scale)
        qj, sj = JF.quantize_activation_mixed(jnp.asarray(x), jp, jcfg)
        qa, sa = F.quantize_activation_mixed(_t(x), tp, cfg)
        _eq(qa, qj)
        _eq(sa, sj)


# ------------------------------------------------------ the projection

def _planned_pair(seed=8, k=1024, n=256, m=16, n_out=24, mag=50.0):
    """A planned projection in both packages, from one plan."""
    rng = np.random.default_rng(seed)
    x = _outlier_acts(rng, m, k, n_out, mag)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    jplan = JF.plan_fmpq(np.abs(x).max(0))
    jqp, jspec = JQL.quantize_linear(jnp.asarray(w), jplan, impl="ref")
    jqp = {key: _val(v) for key, v in jqp.items()}
    tqp, tspec = QL.quantize_linear(_t(w), plan_from_jax(jplan), impl="ref")
    return x, w, jplan, jqp, jspec, tqp, tspec


def test_quantize_linear_and_apply():
    """K = 1,024 with 24 planted outlier channels: a plan with both an
    INT4 and an INT8 range; qparams byte for byte, the output within
    1e-6·max|ref| of the reference's (XLA's summation order)."""
    x, _, jplan, jqp, jspec, tqp, tspec = _planned_pair()
    assert 0 < jplan.k4 < jplan.k
    assert (tspec.k, tspec.n, tspec.k4, tspec.has_perm) == (
        jspec.k, jspec.n, jspec.k4, True)
    for key in ("w_packed", "w_scale", "perm"):
        _eq(tqp[key], jqp[key])
    assert tqp["perm"].dtype == torch.int32
    for dt in (np.float32, "bf16"):
        xj = jnp.asarray(x) if dt is np.float32 else \
            jnp.asarray(x).astype(jnp.bfloat16)
        xt = _t(np.asarray(xj.astype(jnp.float32)))
        if dt == "bf16":
            xt = xt.bfloat16()
        want = np.asarray(JQL.qlinear_apply(jspec, jqp, xj,
                                            out_dtype=jnp.float32))
        got = QL.qlinear_apply(tspec, tqp, xt, out_dtype=torch.float32)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        print(f"planned qlinear_apply ({dt}): {err:.3e} of max|ref|")
        assert err <= 1e-6


def test_quantize_linear_fraction_matches_reference():
    rng = np.random.default_rng(9)
    w = (rng.normal(size=(640, 128)) * 0.05).astype(np.float32)
    x = rng.normal(size=(8, 640)).astype(np.float32)
    for f in (0.875, 0.5, 1.0, 0.0):
        jqp, jspec = JQL.quantize_linear_fraction(jnp.asarray(w), f,
                                                  impl="ref")
        tqp, tspec = QL.quantize_linear_fraction(_t(w), f, impl="ref")
        assert (tspec.k4, tspec.has_perm) == (jspec.k4, False)
        _eq(tqp["w_packed"], _val(jqp["w_packed"]))
        _eq(tqp["w_scale"], _val(jqp["w_scale"]))
        want = np.asarray(JQL.qlinear_apply(
            jspec, {key: _val(v) for key, v in jqp.items()},
            jnp.asarray(x)))
        got = QL.qlinear_apply(tspec, tqp, _t(x)).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("fraction", [0.875, 0.5])
def test_dispatch_honours_perm(fraction):
    """A planned projection through the port's ``C.linear`` (and
    ``dispatch_qlinear`` in f32) against the reference's
    ``_dispatch_qlinear`` under ``quant_runtime``: the input gathered by
    ``perm`` before act-quant, K4 from the runtime's fraction (the plan
    says 896; at 0.5 the runtime says 512)."""
    x, _, _, jqp, _, tqp, _ = _planned_pair(seed=12)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = _t(np.asarray(xb.astype(jnp.float32))).bfloat16()
    rt = JQL.QuantRuntime(int4_fraction=fraction, impl="ref")
    quant = QuantConfig(int4_fraction=fraction, impl="ref")
    with JQL.quant_runtime(rt):
        want32 = np.asarray(JQL._dispatch_qlinear(jqp, xb,
                                                  out_dtype=jnp.float32))
        want = np.asarray(JQL._dispatch_qlinear(jqp, xb)
                          .astype(jnp.float32))
    got32 = QL.dispatch_qlinear(tqp, xt, quant, out_dtype=torch.float32)
    got = C.linear(tqp, xt, quant).float()
    e32 = np.abs(got32.numpy() - want32).max() / np.abs(want32).max()
    e16 = np.abs(got.numpy() - want).max() / np.abs(want).max()
    print(f"dispatch at {fraction}: f32 {e32:.3e}, bf16 {e16:.3e} of max")
    assert e32 <= 1e-6
    assert e16 <= 8e-3           # one bf16 step of the largest output
    spec = QL.qlinear_spec(tqp, quant)
    assert spec.has_perm and spec.k4 == round(fraction * 8) * 128


def test_plan_k4_drives_only_a_direct_apply():
    """The trap: ``qlinear_apply`` with ``quantize_linear``'s spec uses
    the plan's K4, the dispatcher the runtime's, in both packages."""
    x, _, jplan, jqp, jspec, tqp, tspec = _planned_pair(seed=13, n_out=200)
    assert jplan.k4 == tspec.k4 == 768          # 200 outliers: 2 blocks
    quant = QuantConfig(int4_fraction=0.875, impl="ref")
    assert QL.qlinear_spec(tqp, quant).k4 == 896
    direct = QL.qlinear_apply(tspec, tqp, _t(x), out_dtype=torch.float32)
    disp = QL.dispatch_qlinear(tqp, _t(x), quant, out_dtype=torch.float32)
    jdirect = np.asarray(JQL.qlinear_apply(jspec, jqp, jnp.asarray(x),
                                           out_dtype=jnp.float32))
    with JQL.quant_runtime(JQL.QuantRuntime(impl="ref")):
        jdisp = np.asarray(JQL._dispatch_qlinear(jqp, jnp.asarray(x),
                                                 out_dtype=jnp.float32))
    for got, want in ((direct, jdirect), (disp, jdisp)):
        assert np.abs(got.numpy() - want).max() <= \
            1e-6 * np.abs(want).max()
    assert not np.allclose(jdirect, jdisp, rtol=0, atol=1e-3)


def test_fmpq_beats_unpermuted_fraction():
    """FMPQ's error against float64 under 0.8× that of the plan-free
    path at the same INT4 fraction, on outlier-heavy input."""
    rng = np.random.default_rng(3)
    x = _outlier_acts(rng, 256, 1024, 24, 40.0)
    w = (rng.normal(size=(1024, 128)) * 0.05).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    plan = F.plan_fmpq(F.collect_channel_stats(_t(x)).numpy())
    qp, spec = QL.quantize_linear(_t(w), plan, impl="ref")
    fqp, fspec = QL.quantize_linear_fraction(_t(w), plan.int4_fraction,
                                             impl="ref")
    assert fspec.k4 == spec.k4
    err_fmpq = np.abs(QL.qlinear_apply(spec, qp, _t(x)).double().numpy()
                      - exact).mean()
    err_frac = np.abs(QL.qlinear_apply(fspec, fqp, _t(x)).double().numpy()
                      - exact).mean()
    print(f"int4 fraction {plan.int4_fraction:.3f}: FMPQ {err_fmpq:.4e}, "
          f"unpermuted {err_frac:.4e} ({err_fmpq / err_frac:.3f}×)")
    assert err_fmpq < 0.8 * err_frac


# --------------------------------------------------- shared act-quant

@pytest.fixture
def count_act_quant(monkeypatch):
    calls = []
    inner = QL.ops.act_quant_w4ax

    def counted(x, k4, **kw):
        calls.append(k4)
        return inner(x, k4, **kw)

    monkeypatch.setattr(QL.ops, "act_quant_w4ax", counted)
    return calls


def _proj(rng, k, n, perm=None):
    w = torch.from_numpy((rng.normal(size=(k, n)) * 0.05).astype(np.float32))
    packed, scale = Q.quantize_weight_int4(w)
    p = {"w_packed": packed, "w_scale": scale}
    if perm is not None:
        p["perm"] = perm
    return p


def test_two_permutations_never_share_codes(count_act_quant):
    """Two projections of one input with different permutations: each
    output equals its own ``qlinear_apply``, two act-quants; one
    permutation tensor or none: one. Equal but separate tensors quantize
    once each: sharing is by identity, so the forward reads nothing back
    from the card (the builders share equal permutations offline)."""
    rng = np.random.default_rng(21)
    k = 512
    x = _t(_outlier_acts(rng, 6, k, 10, 30.0)).bfloat16()
    pa = torch.from_numpy(rng.permutation(k).astype(np.int32))
    pb = torch.from_numpy(rng.permutation(k).astype(np.int32))
    quant = QuantConfig(int4_fraction=0.75, impl="ref")
    cases = {"different": ([pa, pb], 2), "one tensor": ([pa, pa], 1),
             "equal": ([pa, pa.clone()], 2), "none": ([None, None], 1),
             "one permuted": ([pa, None], 2)}
    for name, (perms, launches) in cases.items():
        projs = [_proj(rng, k, 64, p) for p in perms]
        count_act_quant.clear()
        outs = C.linears(projs, x, quant)
        assert len(count_act_quant) == launches, name
        for p, y in zip(projs, outs):
            alone = QL.qlinear_apply(QL.qlinear_spec(p, quant), p, x)
            assert torch.equal(y, alone.to(torch.bfloat16)), name


def _planned_block(plans_copied: bool = False):
    """A 256-wide llama block quantized with a qkv and an ffn plan
    (``plans_copied``: each projection gets its own equal copy of its
    input's plan) → (cfg, the fp block, the plans, the quantized block,
    the generator)."""
    cfg = dataclasses.replace(get_smoke_config("llama3_8b"), d_model=256,
                              num_heads=4, num_kv_heads=2, head_dim=64)
    lm = LM(cfg, QuantConfig(impl="ref"))
    gen = torch.Generator().manual_seed(0)
    block = lm.init_block(gen, "cpu")
    rng = np.random.default_rng(2)
    qkv = F.plan_fmpq(np.abs(_outlier_acts(rng, 32, 256, 6, 30)).max(0))
    ffn = F.plan_fmpq(np.abs(_outlier_acts(rng, 32, 256, 6, 30)).max(0))
    plans = {"wq": qkv, "wk": qkv, "wv": qkv, "w_up": ffn, "w_gate": ffn}
    if plans_copied:
        plans = {n: dataclasses.replace(p, perm=p.perm.copy())
                 for n, p in plans.items()}
    return cfg, block, plans, lm.quantize_block(block, plans), gen


def _act_quants_a_forward(cfg, qb, gen, count_act_quant) -> int:
    """One layer's ``train_logits`` over ``qb`` → the act-quant calls."""
    lm = LM(cfg)
    params = {"embed": {"table": torch.randn(cfg.vocab_size, 256,
                                             generator=gen).bfloat16()},
              "final_norm": lm._norm("cpu"),
              "lm_head": {"w": torch.randn(256, cfg.vocab_size,
                                           generator=gen).bfloat16()},
              "blocks": [qb]}
    lm1 = LM(dataclasses.replace(cfg, num_layers=1), QuantConfig(impl="ref"))
    count_act_quant.clear()
    lm1.train_logits(params, torch.randint(0, cfg.vocab_size, (2, 5),
                                           generator=gen))
    return len(count_act_quant)


def _shares_one_perm_per_input(qb):
    attn, mlp = qb["attn"], qb["mlp"]
    assert attn["wq"]["perm"] is attn["wk"]["perm"] is attn["wv"]["perm"]
    assert mlp["w_up"]["perm"] is mlp["w_gate"]["perm"]
    assert "perm" not in attn["wo"] and "perm" not in mlp["w_down"]


@pytest.mark.parametrize("plans_copied", [False, True])
def test_planned_block_shares_one_perm_per_input(count_act_quant,
                                                 plans_copied):
    """``LM.quantize_block`` with plans: q/k/v take the qkv plan's perm
    (one tensor), up/gate the ffn plan's, also where each projection has
    its own equal plan (compared on the host); a forward quantizes each
    input once, as the unplanned model does."""
    cfg, block, plans, qb, gen = _planned_block(plans_copied)
    _shares_one_perm_per_input(qb)
    attn, mlp = qb["attn"], qb["mlp"]
    for name, plan in plans.items():
        sub = attn if name.startswith("w") and name in attn else mlp
        qp, _ = QL.quantize_linear(block["attn" if sub is attn else "mlp"]
                                   [name]["w"], plan)
        for key in ("w_packed", "w_scale", "perm"):
            assert torch.equal(sub[name][key], qp[key]), (name, key)
    assert _act_quants_a_forward(cfg, qb, gen, count_act_quant) == 4


def test_converted_planned_params_share_one_perm_per_input(count_act_quant):
    """``convert.params_from_jax`` of planned params whose every
    projection carries its own ``perm`` array (as the reference's tree
    does): a layer's equal permutations become one tensor, so a forward
    quantizes each input once (no content compare on the card)."""
    from repro_torch.convert import params_from_jax
    cfg, _, _, qb, gen = _planned_block()

    def stacked(x):
        if isinstance(x, dict):
            return {k: stacked(v) for k, v in x.items()}
        a = x.numpy()
        return np.stack([a.copy(), a.copy()])      # two layers, own arrays

    tree = params_from_jax({"blocks": stacked(qb)}, device="cpu")
    assert len(tree["blocks"]) == 2
    a0, a1 = (b["attn"]["wq"]["perm"] for b in tree["blocks"])
    assert a0 is not a1                            # one tensor per layer
    for b in tree["blocks"]:
        _shares_one_perm_per_input(b)
        assert b["attn"]["wq"]["perm"] is not b["mlp"]["w_up"]["perm"]
        assert b["attn"]["wq"]["perm"].dtype == torch.int32
        for sub, names in (("attn", ("wq", "wk", "wv")),
                           ("mlp", ("w_up", "w_gate"))):
            for n in names:
                assert torch.equal(b[sub][n]["perm"], qb[sub][n]["perm"])
    assert _act_quants_a_forward(cfg, tree["blocks"][0], gen,
                                 count_act_quant) == 4


@pytest.mark.parametrize("field", ["block_size", "weight_group_size"])
def test_block_sizes_other_than_128_refused(field):
    """The W4Ax kernels read 128-channel blocks: a config or a plan at
    another size is refused, not silently misread."""
    with pytest.raises(ValueError, match=field):
        F.FMPQConfig(**{field: 64})
    plan = F.plan_fmpq(np.ones(256))
    with pytest.raises(ValueError, match="block_size"):
        dataclasses.replace(plan, block_size=64)


# -------------------------------------------------------- refusals

def test_weight_only_refuses_planned_params():
    x, _, _, _, _, tqp, _ = _planned_pair(seed=14)
    with pytest.raises(ValueError, match="perm"):
        QL.dispatch_qlinear(tqp, _t(x), QuantConfig(weight_only=True))


def _planned_smoke(cfg):
    lm = LM(cfg)
    params = lm.init(seed=0, device="cpu")
    blk = params["blocks"][0]
    k = cfg.d_model
    perm = torch.from_numpy(np.random.default_rng(0).permutation(k)
                            .astype(np.int32))
    if "moe" in blk:
        blk["moe"]["w_up"]["perm"] = perm
    else:
        blk["attn"]["wq"]["perm"] = perm
    return params


def test_engine_refuses_planned_params_under_a_mesh():
    cfg = dataclasses.replace(get_smoke_config("llama3_8b"), head_dim=64)
    params = _planned_smoke(cfg)
    with pytest.raises(ValueError, match="item 14"):
        Engine(cfg, params, QuantConfig(impl="ref"),
               EngineConfig(max_batch=2, num_pages=16, page_size=8),
               device="cpu", mesh=Mesh(shape={"data": 1, "model": 2}),
               param_axes=LM(cfg).axes(params))


def test_engine_refuses_a_permuted_expert_stack():
    cfg = get_smoke_config("moonshot_v1_16b_a3b")
    with pytest.raises(ValueError, match="expert stack"):
        Engine(cfg, _planned_smoke(cfg), QuantConfig(impl="ref"),
               EngineConfig(max_batch=2, num_pages=16, page_size=8),
               device="cpu")
