"""The W4A16 weight-only path (``QuantConfig(weight_only=True)``) against
the reference's ``weight_only`` branch of ``_dispatch_qlinear`` (CPU).

The packed weight is dequantized per 128-block in f32 and cast to bf16 on
both sides, bit for bit; the product is a bf16 matmul, which XLA and
PyTorch sum in different f32 orders before the one bf16 rounding, so the
outputs agree within one bf16 step of their magnitude (2^-7 of max|ref|)
and equal on most elements. The engine pair serves the Moonlight smoke
model (MoE: the expert stacks go through the same branch, batched) under
W4A16 in both engines, every forward's logits within 2e-2·max|logit|,
greedy agreement at least 0.9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.core import qlinear as JQL
from repro.core import quantizer as JQ
from repro.models.lm import LM as JLM
from repro.models.lm import QuantConfig as JQuantConfig
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs import base as B
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import qlinear as QL
from repro_torch.core import quantizer as Q
from repro_torch.kernels import ops as OPS
from repro_torch.layers import common as C
from repro_torch.models.lm import QuantConfig
from repro_torch.serving.engine import Engine, EngineConfig

W4A16 = QuantConfig(weight_only=True, impl="ref")
ENGINE = dict(max_batch=4, num_pages=64, page_size=16, max_pages_per_seq=16,
              prefill_chunk_tokens=64, kv_range=4.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packed(rng, shape):
    w = (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32)
    wp, ws = Q.quantize_weight_int4(torch.from_numpy(w))
    return {"w_packed": wp, "w_scale": ws}


def _reference(params, x):
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    with JQL.quant_runtime(JQL.QuantRuntime(weight_only=True)):
        if params["w_packed"].dim() == 3:
            out = jax.vmap(JQL._dispatch_qlinear)(jp, x)
        else:
            out = JQL._dispatch_qlinear(jp, x)
    return np.asarray(out.astype(jnp.float32)), out.dtype


@pytest.mark.parametrize("stack", [False, True], ids=["2d_bias", "experts"])
def test_dispatch_matches_reference(stack):
    """A 2-D projection with an f32 bias (added in bf16), and an expert
    stack ``[E, K/2, N]`` on ``[E, C, K]`` inputs (each expert's rows
    through its own weights): bf16 outputs within 2^-7·max|ref|, equal on
    ≥ 95 % of elements, and no act-quant or W4Ax kernel reached."""
    rng = np.random.default_rng(int(stack))
    if stack:
        params = _packed(rng, (3, 640, 96))
        x = rng.normal(size=(3, 5, 640)).astype(np.float32)
    else:
        params = _packed(rng, (640, 96))
        params["b"] = torch.from_numpy(rng.normal(size=96).astype(np.float32))
        x = rng.normal(size=(2, 7, 640)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want, dtype = _reference(params, xj)
    for kern in OPS.KERNELS.values():
        kern.launches = 0
    got = QL.dispatch_qlinear(params, to_torch(np.asarray(xj), "cpu"), W4A16)
    assert dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert got.shape == want.shape
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()
    assert (got == want).mean() >= 0.95
    assert not any(k.launches for k in OPS.KERNELS.values())


def test_dequantized_weights_are_the_references():
    """The bf16 weight both sides multiply by: the same bits, 2-D and per
    expert of a stack."""
    rng = np.random.default_rng(2)
    for shape in ((256, 64), (2, 384, 32)):
        p = _packed(rng, shape)
        w = Q.dequantize_weight_int4(p["w_packed"], p["w_scale"]).to(
            torch.bfloat16)
        wj = JQ.unpack_int4_interleaved(jnp.asarray(p["w_packed"].numpy()),
                                        axis=-2, block_size=128)
        wj = (wj.astype(jnp.float32) * jnp.repeat(
            jnp.asarray(p["w_scale"].numpy()), 128, axis=-2)).astype(
                jnp.bfloat16)
        np.testing.assert_array_equal(
            w.view(torch.int16).numpy(), np.asarray(wj).view(np.int16))


def test_linears_do_not_share_an_act_quant_under_w4a16():
    """``C.linears`` takes each projection alone (nothing is quantized)."""
    rng = np.random.default_rng(3)
    ps = [_packed(rng, (256, 32)) for _ in range(2)]
    x = torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32))
    outs = C.linears(ps, x, W4A16)
    for o, p in zip(outs, ps):
        assert torch.equal(o, C.linear(p, x, W4A16))


def test_engine_pair_w4a16_moonlight_smoke():
    """Both engines serve the Moonlight smoke model (the reference's own
    random weights, converted) under W4A16 on the pinned workload of
    ``test_torch_engine.py``: every forward's logits within
    2e-2·max|logit|, greedy agreement ≥ 0.9, the same counters."""
    jcfg = JB.get_smoke_config("moonshot_v1_16b_a3b")
    cfg = B.get_smoke_config("moonshot_v1_16b_a3b")
    jqc = JQuantConfig(impl="ref", weight_only=True)
    jlm = JLM(jcfg, quant=jqc)
    qp, _ = jlm.quantize(*jlm.init(jax.random.PRNGKey(4)))
    tp = params_from_jax(jax.tree.map(np.asarray, qp), device="cpu")
    je = JEngine(jcfg, qp, jqc, JEngineConfig(**ENGINE))
    je._fwd = je._unified_forward              # eager, as the other pairs
    te = Engine(cfg, tp, W4A16, EngineConfig(**ENGINE), device="cpu")
    logs = {"j": [], "t": []}
    for eng, key, get in ((je, "j", lambda o: o[0]), (te, "t", lambda o: o)):
        inner = eng._guarded_forward

        def wrapped(*a, inner=inner, key=key, get=get, **k):
            out = inner(*a, **k)
            logs[key].append(np.array(get(out)))
            return out

        eng._guarded_forward = wrapped
    rng = np.random.default_rng(1)
    for i, n in enumerate((20, 9, 27, 5)):
        p = rng.integers(1, cfg.vocab_size, n).tolist()
        je.add_request(i, p, 6)
        te.add_request(i, p, 6)
    jd, td = je.run(), te.run()
    assert len(logs["t"]) == len(logs["j"]) > 1
    for lt, lj in zip(logs["t"], logs["j"]):
        assert lt.shape == lj.shape
        assert np.abs(lt - lj).max() <= 2e-2 * np.abs(lj).max()
    jt = {r.request_id: r.generated for r in jd}
    tt = {r.request_id: r.generated for r in td}
    total = sum(len(v) for v in jt.values())
    agree = sum(a == b for i in jt for a, b in zip(jt[i], tt[i])) / total
    assert agree >= 0.9, (jt, tt)
    for name in ("steps", "forward_calls", "attn_work_items"):
        assert getattr(te, name) == getattr(je, name), name
