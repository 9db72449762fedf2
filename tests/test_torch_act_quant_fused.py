"""The fused act-quant op (both channel ranges of a W4Ax activation in one
launch) and the projections that share it, against the reference (CPU).

* ``act_quant_w4ax_ref`` — the fused op's plain version — equals byte for
  byte the reference's ``ops.act_quant`` over the int4 range ``[0, k4)``
  (bits=4) and the int8 range ``[k4, K)`` (bits=8), from bf16 and f32
  inputs, on rounding ties and all-zero blocks; on tie-free inputs also
  its Pallas kernels in interpret mode (which are not IEEE on exact .5
  ties; see ``tests/test_torch_quantizer.py``).
* ``project_qkv`` and ``mlp_apply`` quantize their input once and are
  ``torch.equal`` to one ``dispatch_qlinear`` per projection, under both
  schedules.
* With the C entry points swapped for stand-ins that run the plain
  versions (the real wrappers and their launch counters run on the CPU),
  one forward of the 2-layer d_model-1024 test model launches the fused
  op 4 times a layer and the single-range K1/K2 never.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro_torch.configs.base import ModelConfig
from repro_torch.core import qlinear as QL
from repro_torch.core import quantizer as Q
from repro_torch.kernels import _build
from repro_torch.kernels import act_quant as AQ
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import w4ax_matmul as WK
from repro_torch.layers import attention as ATT
from repro_torch.layers import common as C
from repro_torch.layers import mlp as MLP
from repro_torch.models.lm import LM, QuantConfig
from repro_torch.serving.engine import Engine, EngineConfig

K = 512
DIMS = dict(name="fused-act-quant", family="dense", num_layers=2,
            d_model=1024, num_heads=8, num_kv_heads=2, head_dim=128,
            d_ff=2048, vocab_size=512, rope_theta=500_000.0)


def _inputs(m: int, k4: int, dtype, seed: int, ties: bool = True):
    """→ (torch input of ``dtype``, the same values for the reference:
    a jnp array of the matching dtype). With ``ties``: a block of each
    range whose scale is exactly 1 (absmax = qmax) holding every odd
    multiple of 0.5 — rounding ties — and an all-zero block."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, K)) * 3).astype(np.float32)
    if ties:
        tie = ((np.arange(128) % 15) - 7) * 0.5
        if k4:
            x[0, :128] = tie
            x[0, 0] = 7.0
        if k4 < K:
            x[0, K - 128:] = tie
            x[0, K - 128] = 127.0
        x[-1, 128:256] = 0.0
    xt = torch.from_numpy(x).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return xt, jnp.asarray(xt.float().numpy()).astype(jdt)


def _reference(xj, k4: int, impl: str):
    """The reference's act_quant over each range; an empty range gives the
    zero-width tensors the port's qlinear builds."""
    m = xj.shape[0]
    empty = (np.zeros((m, 0), np.uint8), np.zeros((m, 0), np.float32),
             np.zeros((m, 0), np.int8), np.zeros((m, 0), np.float32))
    a4, s4 = (JOPS.act_quant(xj[:, :k4], bits=4, impl=impl) if k4
              else empty[:2])
    a8, s8 = (JOPS.act_quant(xj[:, k4:], bits=8, impl=impl) if k4 < K
              else empty[2:])
    return [np.asarray(t) for t in (a4, s4, a8, s8)]


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("m", [1, 5, 64])
@pytest.mark.parametrize("k4", [0, 128, K - 128, K])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_plain_version_matches_reference(dtype, k4, m):
    xt, xj = _inputs(m, k4, dtype, seed=m * 7 + k4)
    want = _reference(xj, k4, "ref")
    _assert_same(AQ.act_quant_w4ax_ref(xt, k4), want)
    # the op keeps leading dims and takes the plain version on the CPU
    got = OPS.act_quant_w4ax(xt.reshape(1, m, K), k4)
    _assert_same([t.reshape(m, -1) for t in got], want)


@pytest.mark.parametrize("k4", [128, K - 128])
def test_fused_plain_version_matches_pallas_interpret(k4):
    """The interpreter divides by a Python scalar and by the scale as
    multiplies by rounded reciprocals (absmax·f32(1/7) was seen where the
    oracle has absmax/7), not IEEE. So each block's absmax here is
    qmax·2^e: its scale is 2^e under either arithmetic and every x/scale
    is exact. The other values are random f32, so no code is a tie."""
    rng = np.random.default_rng(k4)
    x = (rng.normal(size=(5, K)) * 3).astype(np.float32)
    blocks = x.reshape(5, K // 128, 128)
    qmax = np.where(np.arange(K // 128) < k4 // 128, 7.0, 127.0)[None, :]
    amax = np.abs(blocks).max(-1)
    top = np.abs(blocks).argmax(-1)
    pinned = qmax * 2.0 ** np.ceil(np.log2(amax / qmax))
    np.put_along_axis(blocks, top[..., None], (np.sign(np.take_along_axis(
        blocks, top[..., None], -1)) * pinned[..., None]), -1)
    _assert_same(AQ.act_quant_w4ax_ref(torch.from_numpy(x), k4),
                 _reference(jnp.asarray(x), k4, "pallas"))


# ------------------------------------------------- one quantization per input

def _block(seed: int):
    """One layer's packed projections of the test model, from numpy."""
    rng = np.random.default_rng(seed)
    d, f, q, kv = (DIMS["d_model"], DIMS["d_ff"],
                   DIMS["num_heads"] * DIMS["head_dim"],
                   DIMS["num_kv_heads"] * DIMS["head_dim"])

    def lin(i, o):
        w = (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)
        wp, ws = Q.quantize_weight_int4(torch.from_numpy(w))
        return {"w_packed": wp, "w_scale": ws}

    return ({"wq": lin(d, q), "wk": lin(d, kv), "wv": lin(d, kv)},
            {"w_up": lin(d, f), "w_gate": lin(d, f), "w_down": lin(f, d)})


@pytest.mark.parametrize("fraction", [0.875, 0.5])
@pytest.mark.parametrize("schedule", ["split", "mixed"])
def test_shared_act_quant_equals_separate_projections(schedule, fraction):
    cfg = ModelConfig(**DIMS)
    attn, mlp = _block(1)
    quant = QuantConfig(int4_fraction=fraction, schedule=schedule)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 7, DIMS["d_model"]))
                         .astype(np.float32)).bfloat16()
    pos = torch.arange(7)[None].expand(2, 7)

    q, k, v = ATT.project_qkv(attn, cfg, x, pos, quant)
    sep = [QL.dispatch_qlinear(attn[n], x, quant).to(torch.bfloat16)
           for n in ("wq", "wk", "wv")]
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads)
    sep = [s.reshape(2, 7, h, cfg.head_dim) for s, h in zip(sep, heads)]
    want = (C.apply_rope(sep[0], pos, cfg.rope_theta),
            C.apply_rope(sep[1], pos, cfg.rope_theta), sep[2])
    for got, w in zip((q, k, v), want):
        assert torch.equal(got, w)

    up = QL.dispatch_qlinear(mlp["w_up"], x, quant).to(torch.bfloat16)
    gate = QL.dispatch_qlinear(mlp["w_gate"], x, quant).to(torch.bfloat16)
    down = QL.dispatch_qlinear(mlp["w_down"], MLP.silu_bf16(gate) * up, quant)
    assert torch.equal(MLP.mlp_apply(mlp, x, quant),
                       down.to(torch.bfloat16))


# ----------------------------------------------------- launch counts

PLAIN = {
    "act_quant_w4ax": lambda x, tag, stride, m, k, k4, *out: [
        t.copy_(r) for t, r in zip(out, AQ.act_quant_w4ax_ref(x, k4))],
    "w4a4_matmul": lambda a, s, w, ws, out, *_: out.copy_(
        WK.w4a4_matmul_ref(a, s, w, ws)),
    "w4a8_matmul": lambda a, s, w, ws, out, *_: out.copy_(
        WK.w4a8_matmul_ref(a, s, w, ws)),
    "w4ax_matmul_mixed": lambda a4, s4, a8, s8, w, ws, out, *_: out.copy_(
        WK.w4ax_matmul_mixed_ref(a4, s4, a8, s8, w, ws)),
}


@pytest.fixture
def stand_ins(monkeypatch):
    """Every W4Ax C entry point runs its plain version on the CPU; the
    wrappers (checks but the device ones, launch counts) are the real
    ones. → the kernel launch counts, reset."""
    monkeypatch.setattr(_build, "call",
                        lambda lib, fn, dev, *args: PLAIN[fn](*args))
    monkeypatch.setattr(OPS, "use_kernel", lambda impl, t: True)
    monkeypatch.setattr(WK, "_check_gemm", lambda a, a_s, w, w_s, nb, cols:
                        (a.shape[0], w.shape[1]))
    monkeypatch.setattr(AQ, "_check", lambda x: None)
    for kern in OPS.KERNELS.values():
        monkeypatch.setattr(kern, "launches", 0)
    return OPS.KERNELS


def test_specs_that_differ_quantize_separately(stand_ins):
    """Shared only where (k, k4) agree: two specs with another k4 give two
    act-quant launches, each projection the result it gets alone."""
    attn, _ = _block(3)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, DIMS["d_model"])).astype(np.float32)).bfloat16()
    specs = [QL.qlinear_spec(attn[n], QuantConfig(int4_fraction=f))
             for n, f in (("wq", 0.875), ("wk", 0.875), ("wv", 0.5))]
    params = [attn[n] for n in ("wq", "wk", "wv")]
    outs = QL.qlinear_apply_many(specs, params, x)
    assert stand_ins["act_quant_w4ax"].launches == 2
    for spec, p, got in zip(specs, params, outs):
        assert torch.equal(got, QL.qlinear_apply(spec, p, x))


@pytest.mark.parametrize("schedule", ["split", "mixed"])
def test_forward_quantizes_each_input_once(stand_ins, schedule):
    """One forward (the first step: every row a fresh prompt, so no
    attention kernel) launches the fused op for h (q/k/v), the attention
    output (wo), h (up/gate) and the gated product (down): 4 a layer."""
    cfg = ModelConfig(**DIMS)
    params = LM(cfg).init(seed=0, device="cpu")
    eng = Engine(cfg, params, QuantConfig(schedule=schedule),
                 EngineConfig(max_batch=4, num_pages=64, page_size=16,
                              max_pages_per_seq=16, prefill_chunk_tokens=64,
                              kv_range=4.0), device="cpu")
    rng = np.random.default_rng(5)
    for i, n in enumerate((20, 9, 27)):
        eng.add_request(i, rng.integers(1, cfg.vocab_size, n).tolist(), 4)
    eng.step()
    assert eng.forward_calls == 1
    got = {n: k.launches for n, k in stand_ins.items() if k.launches}
    gemms = ({"w4ax_matmul_mixed": 7 * cfg.num_layers} if schedule == "mixed"
             else {"w4a4_matmul": 7 * cfg.num_layers,
                   "w4a8_matmul": 7 * cfg.num_layers})
    assert got == {"act_quant_w4ax": 4 * cfg.num_layers, **gemms}
