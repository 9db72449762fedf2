"""The dense configurations beyond Llama-3 against the reference (CPU,
plain kernel versions): the port's config modules, LayerNorm, the tanh
GELU, biased packed projections, the conversion of biased trees, and the
engine on two 2-layer d_model-1024 models shaped like the new
configurations, with seeded non-zero biases (the reference initializes
them to zero, which would let a dropped bias pass unseen):

* Qwen2.5-shaped: 10/2 heads (G = 5, q_dim 1,280 ≠ d_model), QKV bias;
* StarCoder2-shaped: 12/1 heads (G = 12), LayerNorm, non-gated GELU MLP,
  QKV bias.

The engine pairs reuse ``test_torch_split_step.py``'s harness and its
tolerances (every forward's logits to 2e-2·max|logit|, greedy agreement
≥ 0.9, equal schedule counters) on the pinned prompts of
``test_torch_engine.py``, shortened (2 prompts × 3 new tokens) to keep
the reference's eager forwards quick.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import qlinear as JQL
from repro.kernels import ops as JOPS
from repro.kernels import ref as JR
from repro.layers import common as JC
from repro.models.lm import LM as JLM
from repro.models.lm import QuantConfig as JQuantConfig
from repro_torch.configs import base as B
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import qlinear as QL
from repro_torch.kernels import act_quant as AQ
from repro_torch.kernels import kv4_attention as KA
from repro_torch.layers import common as C
from repro_torch.layers.mlp import gelu_bf16
from repro_torch.models.lm import LM, QuantConfig
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.serving.engine import Engine, EngineConfig
from test_torch_engine import ENGINE, _prompts
from test_torch_split_step import COUNTERS

NEW_IDS = ["llama3_70b", "mistral_nemo_12b", "qwen2_72b", "qwen2p5_32b",
           "starcoder2_15b"]


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ["llama3_8b"] + NEW_IDS)
def test_config_matches_reference(arch, smoke):
    """Every field the port keeps equals the reference's; every field it
    leaves out is at the reference's default (nothing of it is dropped)."""
    get, jget = ((B.get_smoke_config, JB.get_smoke_config) if smoke
                 else (B.get_config, JB.get_config))
    cfg, jcfg = get(arch), jget(arch)
    kept = {f.name for f in dataclasses.fields(ModelConfig)}
    for f in dataclasses.fields(JModelConfig):
        if f.name in kept:
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        else:
            assert getattr(jcfg, f.name) == f.default, f.name
    assert (cfg.q_dim, cfg.kv_dim) == (jcfg.q_dim, jcfg.kv_dim)
    assert arch in B.ARCH_IDS


# ------------------------------------------------------- GELU and norms

def test_gelu_bit_exact_on_every_finite_bf16():
    """All 65,280 finite bf16 values through ``jax.nn.gelu`` (eager, bf16)
    and the port's GELU: every output bit equal."""
    x = np.arange(65536, dtype=np.uint16).view(ml_dtypes.bfloat16)
    x = x[np.isfinite(x.astype(np.float32))]
    assert x.size == 65280
    want = np.asarray(jax.nn.gelu(jnp.asarray(x))).view(np.uint16)
    got = gelu_bf16(to_torch(x, device="cpu"))
    assert got.dtype == torch.bfloat16
    got = got.view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("d", [1024, 6144])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind, d):
    """Random bf16 rows through the reference's ``apply_norm`` and the
    port's: the f32 mean is summed in another order, so an output may sit
    one bf16 step away (0–15 per 393,216 observed), or — where LayerNorm's
    bias cancels the normalized value to near zero — a few steps of that
    tiny value apart. Held: at least 99.99 % of the outputs bit-equal,
    every other within one bf16 step or 1e-6·max|out| of the row."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((64, d)) * 3 + 0.5).astype(ml_dtypes.bfloat16)
    p = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
    want = np.asarray(JC.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x), kind, 1e-5))
    got = C.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                       to_torch(x, device="cpu"), kind, 1e-5)
    assert got.dtype == torch.bfloat16
    gi = got.view(torch.int16).numpy().astype(np.int32)
    wi = want.view(np.int16).astype(np.int32)
    assert (gi == wi).mean() >= 0.9999
    g32, w32 = got.float().numpy(), want.astype(np.float32)
    near = np.abs(g32 - w32) <= 1e-6 * np.abs(w32).max(-1, keepdims=True)
    assert ((np.abs(gi - wi) <= 1) & ((gi < 0) == (wi < 0)) | near).all()


@pytest.mark.parametrize("arch", ["llama3_8b"] + NEW_IDS)
def test_rope_frequencies_match_reference(arch):
    """The RoPE table of every configuration (θ of 10⁵, 5·10⁵ and 10⁶)
    bit for bit: the reference's f32 ``θ ** e`` is the correctly rounded
    power, which an f32 ``torch.pow`` misses on one exponent at θ =
    10⁶."""
    cfg = B.get_config(arch)
    want = np.asarray(JC.rope_frequencies(cfg.head_dim, cfg.rope_theta))
    got = C.rope_frequencies(cfg.head_dim, cfg.rope_theta).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


# --------------------------------------------------- biased projections

@pytest.mark.parametrize("schedule", ["split", "mixed"])
def test_biased_projection_matches_reference(schedule):
    """A packed projection with ``b`` adds the f32 bias to the f32 GEMM
    output before its one cast: bit for bit the reference's epilogue
    (``out + b`` in f32, then ``astype``) on the same GEMM output, and the
    bias moved the result. Against the reference's whole ``qlinear_apply``
    (``impl="ref"``) it is as close as the GEMM's plain version is to the
    reference's oracle (``test_torch_mixed_gemm.py``: f32 sums in another
    order, within 1e-5·max|ref|): f32 outputs within 1e-5·max|ref|, bf16
    outputs at least 99.9 % bit-equal and none more than one bf16 step
    away."""
    rng = np.random.default_rng(5)
    k, n = 1024, 384
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    jq, jspec = JQL.quantize_linear_fraction(jnp.asarray(w), 0.875,
                                             schedule=schedule, impl="ref")
    jq = {key: v.value for key, v in jq.items()}
    tq = {key: to_torch(np.asarray(v), device="cpu") for key, v in jq.items()}
    nob = dict(tq)
    jq["b"], tq["b"] = jnp.asarray(b), torch.from_numpy(b)
    spec = QL.qlinear_spec(tq, QuantConfig(schedule=schedule, impl="ref"))
    assert (spec.k, spec.n, spec.k4) == (jspec.k, jspec.n, jspec.k4)
    for dt in (ml_dtypes.bfloat16, np.float32):
        x = rng.standard_normal((2, 7, k)).astype(dt)
        xt = to_torch(x, device="cpu")
        got = QL.qlinear_apply(spec, tq, xt)
        (many,) = QL.qlinear_apply_many([spec], [tq], xt)
        assert torch.equal(many, got)
        gemm = QL.qlinear_gemm(spec, nob, QL.quantize_act(
            spec, xt.float()))             # an f32 input: the GEMM's f32 out
        epi = np.asarray((jnp.asarray(gemm.numpy()) + jq["b"]).astype(
            jnp.asarray(x).dtype)).astype(np.float32)
        assert np.array_equal(got.float().numpy(), epi)
        assert not torch.equal(QL.qlinear_apply(spec, nob, xt), got)
        want = np.asarray(JQL.qlinear_apply(jspec, jq, jnp.asarray(x)))
        if dt is np.float32:
            err = np.abs(got.numpy() - want).max()
            assert err <= 1e-5 * np.abs(want).max(), err
        else:
            gi = got.view(torch.int16).numpy().astype(np.int32)
            wi = want.view(np.int16).astype(np.int32)
            assert (gi == wi).mean() >= 0.999
            assert (np.abs(gi - wi) <= 1).all()


# d_model and d_ff of the new configurations; Qwen2-72B's 29,568 is 231
# blocks, an odd 202 int4 + 29 int8 at int4_fraction 0.875
ARCH_WIDTHS = (5120, 6144, 8192, 24576, 27648, 28672, 29568)


@pytest.mark.parametrize("k", ARCH_WIDTHS)
def test_act_quant_at_arch_widths(k):
    """The fused act-quant's plain version at each width with the split
    the engine gives it (``qlinear_spec`` at 0.875), byte for byte the
    reference's ``act_quant`` over each range, on bf16 rows as the
    projections hand them over."""
    n = 256
    w = {"w_packed": torch.zeros((k // 2, n), dtype=torch.uint8),
         "w_scale": torch.zeros((k // 128, n))}
    k4 = QL.qlinear_spec(w, QuantConfig(impl="ref")).k4
    assert k4 == int(round(0.875 * (k // 128))) * 128
    x = (np.random.default_rng(k).standard_normal((3, k)) * 3).astype(
        ml_dtypes.bfloat16)
    got = AQ.act_quant_w4ax_ref(to_torch(x, device="cpu"), k4)
    xj = jnp.asarray(x)
    want = (JOPS.act_quant(xj[:, :k4], bits=4, impl="ref")
            + JOPS.act_quant(xj[:, k4:], bits=8, impl="ref"))
    for g, wt in zip(got, want):
        wt = np.asarray(wt)
        assert g.shape == wt.shape and np.array_equal(g.numpy(), wt)


# ------------------------------------------------------ the two models

SHAPES = {
    "qwen2p5": dict(name="qwen2.5-shaped", family="dense", num_layers=2,
                    d_model=1024, num_heads=10, num_kv_heads=2,
                    head_dim=128, d_ff=2048, vocab_size=512,
                    rope_theta=1_000_000.0, qkv_bias=True),
    "starcoder2": dict(name="starcoder2-shaped", family="dense",
                       num_layers=2, d_model=1024, num_heads=12,
                       num_kv_heads=1, head_dim=128, d_ff=2048,
                       vocab_size=512, rope_theta=100_000.0, qkv_bias=True,
                       norm="layernorm", mlp_act="gelu"),
}


def _fp_params(dims: dict, seed=0):
    """Reference-layout fp params (stacked blocks) made with numpy, with
    non-zero q/k/v biases and LayerNorm biases and scales off 1."""
    rng = np.random.default_rng(seed)
    n, d, f, v = (dims["num_layers"], dims["d_model"], dims["d_ff"],
                  dims["vocab_size"])
    qd = dims["num_heads"] * dims["head_dim"]
    kvd = dims["num_kv_heads"] * dims["head_dim"]

    def lin(i, o, bias=False):
        p = {"w": (rng.standard_normal((n, i, o)) / np.sqrt(i))
             .astype(np.float32)}
        if bias:
            p["b"] = (0.5 * rng.standard_normal((n, o))).astype(np.float32)
        return p

    def norm(*lead):
        p = {"scale": (1 + 0.1 * rng.standard_normal(lead + (d,)))
             .astype(np.float32)}
        if dims.get("norm") == "layernorm":
            p["bias"] = (0.1 * rng.standard_normal(lead + (d,))
                         ).astype(np.float32)
        return p

    mlp = {"w_up": lin(d, f), "w_down": lin(f, d)}
    if dims.get("mlp_act", "swiglu") == "swiglu":
        mlp["w_gate"] = lin(d, f)
    blocks = {
        "attn_norm": norm(n), "mlp_norm": norm(n),
        "attn": {"wq": lin(d, qd, True), "wk": lin(d, kvd, True),
                 "wv": lin(d, kvd, True), "wo": lin(qd, d)},
        "mlp": mlp,
    }
    return {
        "embed": {"table": rng.standard_normal((v, d)).astype(np.float32)},
        "final_norm": norm(),
        "lm_head": {"w": (rng.standard_normal((d, v)) / np.sqrt(d))
                    .astype(np.float32)},
        "blocks": blocks,
    }


def build_model(dims: dict):
    """The reference's quantized tree of ``_fp_params`` and its conversion
    → (reference config, port config, reference quant config, reference
    params, port params)."""
    jcfg, cfg = JModelConfig(**dims), ModelConfig(**dims)
    jqc = JQuantConfig(weight_only=False, impl="ref")
    fp = jax.tree.map(jnp.asarray, _fp_params(dims))
    qparams, _ = JLM(jcfg, quant=jqc).quantize(
        fp, jax.tree.map(lambda a: None, fp))
    tparams = params_from_jax(jax.tree.map(np.asarray, qparams),
                              device="cpu")
    return jcfg, cfg, jqc, qparams, tparams


@pytest.fixture(scope="module")
def qwen_model():
    return build_model(SHAPES["qwen2p5"])


@pytest.fixture(scope="module", params=list(SHAPES))
def arch_model(request, qwen_model):
    if request.param == "qwen2p5":
        return qwen_model
    return build_model(SHAPES[request.param])


def test_params_from_jax_carries_biases(arch_model):
    """The projection biases ``b`` and the LayerNorm ``bias`` arrive per
    layer, bit for bit, beside the packed weights."""
    jcfg, cfg, _, qparams, tparams = arch_model
    jb = qparams["blocks"]
    for li, bt in enumerate(tparams["blocks"]):
        for key in ("wq", "wk", "wv"):
            want = np.asarray(jb["attn"][key]["b"][li])
            assert np.abs(want).max() > 0
            assert np.array_equal(bt["attn"][key]["b"].numpy(), want)
            assert "w_packed" in bt["attn"][key]
        assert "b" not in bt["attn"]["wo"]
        for nm in ("attn_norm", "mlp_norm"):
            assert set(bt[nm]) == set(jb[nm])
            for key in bt[nm]:
                assert np.array_equal(bt[nm][key].numpy(),
                                      np.asarray(jb[nm][key][li]))
        assert ("w_gate" in bt["mlp"]) == (cfg.mlp_act == "swiglu")
    assert set(tparams["final_norm"]) == (
        {"scale", "bias"} if cfg.norm == "layernorm" else {"scale"})


def test_lm_init_follows_config(arch_model):
    """The port's own random init: biases zero as the reference's, kept
    through quantization; LayerNorm norms carry a zero bias; no
    ``w_gate`` under GELU."""
    cfg = dataclasses.replace(arch_model[1], num_layers=1, d_model=256,
                              d_ff=512)
    p = LM(cfg).init(seed=1, device="cpu")
    blk = p["blocks"][0]
    assert blk["attn"]["wq"]["b"].shape == (cfg.q_dim,)
    assert blk["attn"]["wk"]["b"].shape == (cfg.kv_dim,)
    assert float(blk["attn"]["wv"]["b"].abs().max()) == 0.0
    assert "w_packed" in blk["attn"]["wq"] and "b" not in blk["attn"]["wo"]
    ln = cfg.norm == "layernorm"
    assert ("bias" in blk["attn_norm"]) == ln == ("bias" in p["final_norm"])
    assert ("w_gate" in blk["mlp"]) == (cfg.mlp_act == "swiglu")


LENS, NEW = (12, 5), 3
ENGINE_CONFIGS = {
    "unified_work_queue": {},
    "split_work_queue": dict(unified_step=False),
    "split_dense": dict(unified_step=False, attention_schedule="dense"),
    "whole_gather": dict(prefill_mode="whole", decode_attention="gather"),
}


@pytest.fixture
def xla_trig(monkeypatch):
    """The port's RoPE with XLA's f32 cos and sin (its only use of
    ``torch.cos``/``torch.sin``). XLA's CPU trigonometry differs from
    PyTorch's in the last bit on ~5 % of the angles of a 4,096-position
    table (and neither is correctly rounded); a last-bit difference in q
    or k flips int4 act-quant codes downstream, and the norm of the next
    layer spreads a flipped element over its whole row. With the same
    trigonometry on both sides the forwards differ only by the f32
    summation order of the GEMM's plain version and of the attention
    oracles."""
    def xla(fn):
        return lambda t: torch.from_numpy(np.array(fn(t.numpy())))
    monkeypatch.setattr(torch, "cos", xla(jnp.cos))
    monkeypatch.setattr(torch, "sin", xla(jnp.sin))


@pytest.fixture
def f32_gather(monkeypatch):
    """K10's plain versions computing in f32 on both sides, as K10 and its
    plain version do on the card and the reference's Pallas kernel does.
    On a CPU tensor both ops' plain paths round the dequantized operands
    and the probabilities to bf16, where a last-bit f32 difference of the
    two sides' sums can land an operand on its other bf16 neighbour."""
    jk, tk = JR.kv4_decode_attention_ref, KA.kv4_decode_attention_ref
    monkeypatch.setattr(JR, "kv4_decode_attention_ref",
                        lambda *a, compute_dtype=None: jk(
                            *a, compute_dtype=jnp.float32))
    monkeypatch.setattr(KA, "kv4_decode_attention_ref",
                        lambda *a, compute_dtype=None: tk(
                            *a, compute_dtype=torch.float32))


def _log_forwards(eng, logs: list, unified: bool):
    """Record the logits of every forward: the unified step's
    ``_guarded_forward`` results, or the rows the split forwards hand to
    ``_sample_batch``."""
    name = "_guarded_forward" if unified else "_sample_batch"
    inner = getattr(eng, name)

    def wrapped(*a, **k):
        out = inner(*a, **k)
        logs.append(np.array(out[0] if unified and isinstance(out, tuple)
                             else out if unified else a[0]))
        return out

    setattr(eng, name, wrapped)


def check_engine_pair(model, config: str):
    """The JAX engine (eager) and the port's on the same converted weights
    and requests in one engine configuration: every forward's logits
    within 2e-2·max|logit|, the tolerance of ``test_torch_split_step.py``
    (observed: every forward bit for bit but the last at G = 12, 2.8e-4·
    max|logit| apart — f32 sums of the GEMM's plain version and of the
    attention oracles in another order), greedy agreement ≥ 0.9 (on these
    6 tokens: all equal) and the same schedule counters. The gather decode
    runs K10's plain versions in f32 (``f32_gather``)."""
    jcfg, cfg, jqc, qparams, tparams = model
    kw = {**ENGINE, **ENGINE_CONFIGS[config]}
    je = JEngine(jcfg, qparams, jqc, JEngineConfig(**kw))
    je._fwd = je._unified_forward       # eager: see test_torch_engine.py
    te = Engine(cfg, tparams, QuantConfig(impl="ref"), EngineConfig(**kw),
                device="cpu")
    out = {}
    for key, eng in (("j", je), ("t", te)):
        logs: list = []
        _log_forwards(eng, logs, config == "unified_work_queue")
        for i, prompt in enumerate(_prompts(LENS)):
            eng.add_request(i, prompt, NEW)
        done = eng.run()
        out[key] = (logs, {r.request_id: list(r.generated) for r in done},
                    {k: getattr(eng, k) for k in COUNTERS})
    (lj, tj, cj), (lt, tt, ct) = out["j"], out["t"]
    assert len(lt) == len(lj) >= NEW
    for step, (a, b) in enumerate(zip(lt, lj)):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), step
    assert sorted(tt) == sorted(tj) == list(range(len(LENS)))
    assert all(len(v) == NEW for v in tt.values())
    agree = sum(a == b for i in tj for a, b in zip(tj[i], tt[i]))
    assert agree >= 0.9 * len(LENS) * NEW, (tj, tt)
    assert ct == cj
    c = te.counters()
    assert c["failed_count"] == c["internal_errors"] == 0, c["last_error"]
    if config != "whole_gather":
        assert ct["attn_forwards"] > 0


@pytest.mark.parametrize("config", ["split_work_queue", "split_dense",
                                    "whole_gather"])
def test_engine_matches_reference(qwen_model, config, xla_trig, f32_gather):
    """The Qwen2.5-shaped model (G = 5) on the three decode paths (the
    plain K8, K6 and K10). Its unified step is left to the StarCoder2-
    shaped pair (``test_torch_gqa_decode.py``), which runs the unified
    body with a bias, LayerNorm and GELU, and to ``test_torch_engine.py``
    (RMSNorm, SwiGLU): each reference engine pair costs ~40 s of the
    reference's eager op compiles."""
    check_engine_pair(qwen_model, config)
