"""The port's own model forward (``LM.prefill``/``decode``/
``train_logits`` over the contiguous caches) against the JAX reference's
on the same weights and prompts (CPU, plain kernel versions).

Test model: ``test_torch_engine.py``'s (2 layers, d_model 1,024, 8/2
heads × 128, d_ff 2,048, vocab 512): wide enough that every projection
runs W4A4 and W4A8. Cases, in order: fp params (bf16 cache); quantized
params with the int4 cache (``kv4=True``, decode through K10's plain
version); quantized params with the bf16 cache; FMPQ-planned params
(24 planted outlier channels ×50 in every norm scale, plans from each
layer's qkv and ffn inputs, ``perm`` on q/k/v and up/gate, the plans
held byte for byte between the packages); and the Qwen3-MoE smoke
config, prefill only (capacity depends on the forward's tensor). Each
quantized case also holds its first logits' distance from the fp
model's to the reference's (the planned case beside its unplanned
model's).

The reference runs under ``jax.disable_jit()``: its layer scan then runs
op by op, as the engine tests run its forwards (jitted, XLA reorders the
f32 work around the int4 act-quant and the reference disagrees with
itself, ROADMAP caveats). XLA's trigonometry is swapped into the port's
RoPE and PyTorch runs on one thread. Criteria: prefill, decode and
training logits within 2e-2·max|logit| (the error printed; the engine
tests reach 0 on their pinned workload), each side's greedy tokens equal
on this pinned workload, the caches' bytes equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import get_smoke_config as j_smoke
from repro.core import fmpq as JF
from repro.core import qlinear as JQL
from repro.models.lm import LM as JLM
from repro.models.lm import QuantConfig as JQuantConfig
from repro_torch.configs.base import ModelConfig, get_smoke_config
from repro_torch.convert import params_from_jax, plan_from_jax
from repro_torch.core import fmpq as F
from repro_torch.layers import attention as ATT
from repro_torch.layers import common as C
from repro_torch.layers import mlp as MLP
from repro_torch.models.lm import LM, QuantConfig

DIMS = dict(name="torch-lm", family="dense", num_layers=2, d_model=1024,
            num_heads=8, num_kv_heads=2, head_dim=128, d_ff=2048,
            vocab_size=512, rope_theta=500_000.0)
BATCH, PROMPT, MAX_LEN, STEPS = 2, 12, 24, 4
TOL = 2e-2
OUTLIERS, MAG = 24, 50.0
CASES = ("fp", "q4", "q4 bf16 cache", "planned")


@pytest.fixture(scope="module", autouse=True)
def pinned():
    """One PyTorch thread, and XLA's f32 cos/sin in the port's RoPE."""
    def xla(fn):
        return lambda t: torch.from_numpy(np.array(fn(t.numpy())))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "cos", xla(jnp.cos))
        mp.setattr(torch, "sin", xla(jnp.sin))
        yield
    torch.set_num_threads(n)


def _fp_params(planted: bool, seed=0):
    """Reference-layout fp params (stacked blocks), made with numpy;
    ``planted``: 24 seeded channels of every norm scale ×50."""
    rng = np.random.default_rng(seed)
    n, d, f, v = (DIMS[k] for k in ("num_layers", "d_model", "d_ff",
                                    "vocab_size"))

    def lin(i, o):
        return {"w": (rng.standard_normal((n, i, o)) / np.sqrt(i))
                .astype(np.float32)}

    def norm():
        s = np.ones((n, d), np.float32)
        if planted:
            for li in range(n):
                s[li, rng.choice(d, OUTLIERS, replace=False)] = MAG
        return {"scale": s}

    blocks = {"attn_norm": norm(), "mlp_norm": norm(),
              "attn": {"wq": lin(d, 1024), "wk": lin(d, 256),
                       "wv": lin(d, 256), "wo": lin(1024, d)},
              "mlp": {"w_up": lin(d, f), "w_gate": lin(d, f),
                      "w_down": lin(f, d)}}
    return {"embed": {"table": rng.standard_normal((v, d))
                      .astype(np.float32)},
            "final_norm": {"scale": np.ones(d, np.float32)},
            "lm_head": {"w": (rng.standard_normal((d, v)) / np.sqrt(d))
                        .astype(np.float32)},
            "blocks": blocks}


def _prompts(vocab, seed=1):
    return np.random.default_rng(seed).integers(
        1, vocab, (BATCH, PROMPT)).astype(np.int32)


def _calibrate(cfg, tparams_fp, tokens):
    """Each layer's qkv and ffn input absmax (float64), by an unrolled
    fp forward of the port, as ``benchmarks/fmpq_ratio.py``'s
    ``collect_linear_stats`` records them."""
    lm = LM(cfg)
    x = lm.embed(tparams_fp, tokens)
    pos = torch.arange(x.shape[1]).expand(x.shape[:2])
    stats = []
    for bp in tparams_fp["blocks"]:
        h = C.apply_norm(bp["attn_norm"], x, cfg.norm, cfg.norm_eps)
        qkv = h.float().reshape(-1, h.shape[-1]).abs().amax(0).double()
        x = x + ATT.attention_train(bp["attn"], cfg, h, pos)
        h = C.apply_norm(bp["mlp_norm"], x, cfg.norm, cfg.norm_eps)
        ffn = h.float().reshape(-1, h.shape[-1]).abs().amax(0).double()
        x = x + MLP.mlp_apply(bp["mlp"], h)
        stats.append((qkv.numpy(), ffn.numpy()))
    return stats


PLANNED = {"attn": ("wq", "wk", "wv"), "mlp": ("w_up", "w_gate")}


def _plan_params(jq, fp, stats):
    """The reference's quantized params with q/k/v and up/gate rebuilt by
    its ``quantize_linear`` from each layer's plans (stacked again)."""
    jq = jax.tree.map(lambda a: a, jq)
    jplans = [(JF.plan_fmpq(qkv), JF.plan_fmpq(ffn)) for qkv, ffn in stats]
    for sub, names in PLANNED.items():
        for name in names:
            per = [JQL.quantize_linear(
                jnp.asarray(fp["blocks"][sub][name]["w"][li]),
                jplans[li][0 if sub == "attn" else 1], impl="ref")[0]
                for li in range(DIMS["num_layers"])]
            jq["blocks"][sub][name] = {
                k: jnp.stack([p[k].value for p in per]) for k in per[0]}
    return jq, jplans


def _build(case):
    jcfg, cfg = JModelConfig(**DIMS), ModelConfig(**DIMS)
    planted = case == "planned"
    fp_np = _fp_params(planted)
    fp = jax.tree.map(jnp.asarray, fp_np)
    tokens = _prompts(DIMS["vocab_size"])
    tfp = params_from_jax(fp_np, device="cpu")
    if case == "fp":
        return jcfg, cfg, None, None, fp, tfp, tokens, {}
    kv4 = case != "q4 bf16 cache"
    jqc = JQuantConfig(impl="ref", kv4=kv4)
    qc = QuantConfig(impl="ref", kv4=kv4)
    jq, _ = JLM(jcfg, quant=jqc).quantize(
        fp, jax.tree.map(lambda a: None, fp))
    # the first logits of the fp model (and, planned, of the unplanned
    # quantized model) on the same weights, in both packages
    extra = {"fp": _first_logits(jcfg, None, fp, cfg, None, tfp, tokens)}
    if planted:
        extra["unplanned"] = _first_logits(
            jcfg, jqc, jq, cfg, qc,
            params_from_jax(jax.tree.map(np.asarray, jq), device="cpu"),
            tokens)
        stats = _calibrate(cfg, tfp, torch.from_numpy(tokens).long())
        jq, jplans = _plan_params(jq, fp_np, stats)
        extra.update(stats=stats, jplans=jplans)
    tparams = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    return jcfg, cfg, jqc, qc, jq, tparams, tokens, extra


def _first_logits(jcfg, jqc, jparams, cfg, qc, tparams, tokens):
    """(the reference's, the port's) prefill logits of the last prompt
    position."""
    return (_ref_run(jcfg, jqc, jparams, tokens, 0)["logits"][0],
            _port_run(cfg, qc, tparams, tokens, 0)["logits"][0])


def _np_cache(cache, layered):
    """Per-layer numpy copies of a cache's packed or bf16 tensors."""
    keys = [k for k in ("k_packed", "v_packed", "k", "v") if k in
            (cache["attn"] if layered else cache["attn"][0])]
    if layered:                  # the reference's [L, ...] stacks
        return {k: np.asarray(cache["attn"][k].astype(jnp.float32)
                              if cache["attn"][k].dtype == jnp.bfloat16
                              else cache["attn"][k]) for k in keys}
    return {k: np.stack([c[k].float().numpy() if c[k].dtype ==
                         torch.bfloat16 else c[k].numpy().copy()
                         for c in cache["attn"]]) for k in keys}


def _ref_run(jcfg, jqc, jparams, tokens, steps):
    jlm = JLM(jcfg, quant=jqc)
    out = {"logits": [], "tokens": [], "caches": []}
    with jax.disable_jit():
        cache = jlm.init_cache(BATCH, MAX_LEN)
        lg, cache = jlm.prefill(jparams, jnp.asarray(tokens), cache)
        out["caches"].append(_np_cache(cache, True))
        for _ in range(steps):
            out["logits"].append(np.asarray(lg[:, -1]))
            tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
            out["tokens"].append(np.asarray(tok))
            lg, cache = jlm.decode(jparams, tok[:, None], cache)
        out["logits"].append(np.asarray(lg[:, -1]))
        out["caches"].append(_np_cache(cache, True))
        if steps:
            out["train"] = np.asarray(jlm.train_logits(
                jparams, jnp.asarray(tokens))[0])
    return out


def _port_run(cfg, qc, tparams, tokens, steps):
    lm = LM(cfg, qc)
    out = {"logits": [], "tokens": [], "caches": []}
    cache = lm.init_cache(BATCH, MAX_LEN, device="cpu")
    lg, cache = lm.prefill(tparams, torch.from_numpy(tokens).long(), cache)
    out["caches"].append(_np_cache(cache, False))
    for _ in range(steps):
        out["logits"].append(lg[:, -1].numpy())
        tok = lg[:, -1].argmax(-1)
        out["tokens"].append(tok.numpy().astype(np.int32))
        lg, cache = lm.decode(tparams, tok[:, None], cache)
    out["logits"].append(lg[:, -1].numpy())
    out["caches"].append(_np_cache(cache, False))
    if steps:
        out["train"] = lm.train_logits(
            tparams, torch.from_numpy(tokens).long())[0].numpy()
    out["lengths"] = [c["length"].tolist() for c in cache["attn"]]
    return out


@pytest.fixture(scope="module", params=CASES)
def pair(request):
    jcfg, cfg, jqc, qc, jparams, tparams, tokens, extra = _build(
        request.param)
    return (request.param, _ref_run(jcfg, jqc, jparams, tokens, STEPS),
            _port_run(cfg, qc, tparams, tokens, STEPS), tparams, extra)


def _err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_prefill_and_decode_logits(pair):
    case, ref, port = pair[:3]
    assert len(port["logits"]) == len(ref["logits"]) == STEPS + 1
    errs = [_err(g, w) for g, w in zip(port["logits"], ref["logits"])]
    print(f"{case}: prefill + decode logit error / max|logit|: {errs}")
    assert all(np.isfinite(g).all() for g in port["logits"])
    assert max(errs) <= TOL


def test_greedy_tokens_equal(pair):
    case, ref, port = pair[:3]
    print(f"{case}: tokens {np.stack(port['tokens']).T.tolist()}")
    np.testing.assert_array_equal(np.stack(port["tokens"]),
                                  np.stack(ref["tokens"]))


def test_train_logits(pair):
    case, ref, port = pair[:3]
    assert port["train"].shape == ref["train"].shape == (
        BATCH, PROMPT, DIMS["vocab_size"])
    err = _err(port["train"], ref["train"])
    print(f"{case}: train_logits error / max|logit|: {err:.3e}")
    assert err <= TOL


def test_cache_bytes_equal(pair):
    """After the prefill and after the last decode step, each layer: the
    packed int4 cache byte for byte. A bf16 cache holds the bf16 k/v
    projections themselves, where the fp model's bf16 matmuls (XLA's and
    PyTorch's sum in other orders) leave last-bit differences that the
    next layer's norm spreads over a row: it is held like the logits."""
    case, ref, port = pair[:3]
    for stage, (got, want) in enumerate(zip(port["caches"], ref["caches"])):
        assert sorted(got) == sorted(want)
        for key in got:
            assert got[key].shape == want[key].shape, (case, key)
            same = float((got[key] == want[key]).mean())
            print(f"{case} stage {stage} {key}: share equal {same:.6f}")
            if key.endswith("_packed"):
                np.testing.assert_array_equal(got[key], want[key])
            else:
                err = _err(got[key], want[key])
                print(f"{case} stage {stage} {key}: error / max {err:.3e}")
                assert err <= TOL, (case, key)
    assert port["lengths"] == [[PROMPT + STEPS] * BATCH] * DIMS["num_layers"]
    packed = case not in ("fp", "q4 bf16 cache")
    assert ("k_packed" in port["caches"][0]) == packed
    if packed:
        assert (port["caches"][-1]["k_packed"] != 0).any()


def test_planned_params_carry_the_plans(pair):
    """The planned case: each layer's plans equal in both packages, the
    port's ``LM.quantize_block(plans=)`` builds the reference's bytes, and
    the planted outliers make an INT8 tail. The other cases carry no
    ``perm``."""
    case, _, _, tparams, extra = pair
    perms = [(li, sub, n) for li, b in enumerate(tparams["blocks"])
             for sub in ("attn", "mlp") for n in b[sub] if "perm" in b[sub][n]]
    if case != "planned":
        assert perms == []
        return
    assert sorted(perms) == sorted(
        (li, sub, n) for li in range(DIMS["num_layers"])
        for sub, names in PLANNED.items() for n in names)
    for b in tparams["blocks"]:          # one tensor per input, converted
        assert b["attn"]["wq"]["perm"] is b["attn"]["wk"]["perm"] \
            is b["attn"]["wv"]["perm"]
        assert b["mlp"]["w_up"]["perm"] is b["mlp"]["w_gate"]["perm"]
    fp = _fp_params(True)
    lm = LM(ModelConfig(**DIMS))
    for li, (qkv, ffn) in enumerate(extra["stats"]):
        tq, tf = F.plan_fmpq(qkv), F.plan_fmpq(ffn)
        jq, jf = extra["jplans"][li]
        for got, want in ((tq, jq), (tf, jf)):
            np.testing.assert_array_equal(got.perm, want.perm)
            np.testing.assert_array_equal(got.block_bits, want.block_bits)
            assert got.num_int4_blocks == want.num_int4_blocks
            assert plan_from_jax(want).k4 == got.k4
        print(f"layer {li}: qkv int4 fraction {tq.int4_fraction:.3f}, "
              f"ffn {tf.int4_fraction:.3f}")
        assert 0 < tq.num_int4_blocks < tq.num_blocks
        block = {sub: {n: {"w": torch.from_numpy(np.array(
            fp["blocks"][sub][n]["w"][li]))} for n in fp["blocks"][sub]}
            for sub in ("attn", "mlp")}
        plans = {n: tq for n in PLANNED["attn"]}
        plans.update({n: tf for n in PLANNED["mlp"]})
        built = lm.quantize_block(block, plans)
        for sub, names in PLANNED.items():
            for n in names:
                for key in ("w_packed", "w_scale", "perm"):
                    assert torch.equal(built[sub][n][key],
                                       tparams["blocks"][li][sub][n][key])


def test_distance_from_fp_is_the_reference_s(pair):
    """Each quantized model's first logits are as far from the fp model's
    in the port as in the reference (within 2e-2 of max|fp logit|), so
    the distance belongs to the quantization, not to the port's forward.
    The planned case (24 channels of every norm scale ×50) also serves
    its unplanned quantized model: FMPQ's gain over it is the
    reference's, and planning lowers the error in both."""
    case, ref, port, _, extra = pair
    if case == "fp":
        assert extra == {}
        return
    jfp, tfp = extra["fp"]
    runs = {case: (ref["logits"][0], port["logits"][0])}
    if case == "planned":
        runs["unplanned"] = extra["unplanned"]
    dist = {}
    for label, (jl, tl) in runs.items():
        dist[label] = (_err(jl, jfp), _err(tl, tfp))
        print(f"{case}: {label} first-logit error against fp / max|fp|: "
              f"reference {dist[label][0]:.5f}, port {dist[label][1]:.5f}")
        assert abs(dist[label][0] - dist[label][1]) <= TOL
    if case == "planned":
        (jp, tp), (ju, tu) = dist["planned"], dist["unplanned"]
        print(f"FMPQ's gain (unplanned ÷ planned): reference "
              f"{ju / jp:.3f}, port {tu / tp:.3f}")
        assert jp < ju and tp < tu


def test_decode_clamps_past_the_cache():
    """A decode at ``length = max_len`` writes the last slot, as the
    reference's ``dynamic_update_slice`` clamps; ``length`` goes on."""
    cfg = get_smoke_config("llama3_8b")
    lm = LM(cfg, QuantConfig(impl="ref"))
    params = lm.init(seed=0, device="cpu")
    for kv4 in (True, False):
        lm = LM(cfg, QuantConfig(impl="ref", kv4=kv4))
        cache = lm.init_cache(2, 6, device="cpu")
        tok = torch.randint(0, cfg.vocab_size, (2, 6))
        _, cache = lm.prefill(params, tok, cache)
        key = "k_packed" if kv4 else "k"
        before = cache["attn"][0][key].clone()
        lg, cache = lm.decode(params, tok[:, :1], cache)
        after = cache["attn"][0][key]
        slot = 2 if kv4 else 1
        assert torch.equal(before.narrow(slot, 0, 5), after.narrow(slot, 0, 5))
        assert not torch.equal(before.narrow(slot, 5, 1),
                               after.narrow(slot, 5, 1))
        assert cache["attn"][0]["length"].tolist() == [7, 7]
        assert torch.isfinite(lg).all()
        with pytest.raises(ValueError, match="does not fit"):
            lm.prefill(params, torch.zeros((2, 7), dtype=torch.long),
                       lm.init_cache(2, 6, device="cpu"))


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "rwkv6_1p6b",
                                  "llama3p2_vision_90b", "hubert_xlarge"])
def test_other_families_refused(arch):
    """The paged engine serves the dense and moe families only, and
    refuses the others in the reference's words (they serve through
    ``LM.prefill``/``decode``, which accepts them)."""
    from repro_torch.serving.engine import Engine
    cfg = get_smoke_config(arch)
    params = LM(cfg, QuantConfig(impl="ref")).init(seed=0, device="cpu")
    with pytest.raises(ValueError, match=f"paged engine supports dense/moe; "
                       f"{cfg.family} serves via LM.decode"):
        Engine(cfg, params, QuantConfig(impl="ref"), device="cpu")


def test_moe_prefill():
    """Qwen3-MoE's smoke config (QK-norm, 8 experts top-2), quantized by
    the reference: prefill logits and the int4 cache bytes."""
    jcfg = j_smoke("qwen3_moe_235b_a22b")
    cfg = get_smoke_config("qwen3_moe_235b_a22b")
    params, axes = JLM(jcfg).init(jax.random.PRNGKey(0))
    jqc = JQuantConfig(impl="ref")
    jq, _ = JLM(jcfg, quant=jqc).quantize(params, axes)
    tparams = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    tokens = _prompts(cfg.vocab_size, seed=3)
    ref = _ref_run(jcfg, jqc, jq, tokens, 0)
    port = _port_run(cfg, QuantConfig(impl="ref"), tparams, tokens, 0)
    err = _err(port["logits"][0], ref["logits"][0])
    print(f"moe prefill logit error / max|logit|: {err:.3e}")
    assert err <= TOL
    for key in ("k_packed", "v_packed"):
        np.testing.assert_array_equal(port["caches"][0][key],
                                      ref["caches"][0][key])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_over_chunks(causal):
    """Past 1,024 queries and keys both packages chunk (the reference's
    q_chunk/kv_chunk) and carry the online softmax across key chunks:
    1,100 positions, GQA 4/2, within 1e-5 of max|ref|."""
    from repro.layers import attention as JATT
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(1, 1100, h, 32)).astype(np.float32)
               for h in (4, 2, 2))
    want = np.asarray(JATT.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = ATT.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal).numpy()
    err = _err(got, want)
    print(f"flash attention, 1,100 positions, causal={causal}: {err:.3e}")
    assert err <= 1e-5
