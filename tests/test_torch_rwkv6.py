"""The port's RWKV-6 layer (``layers/rwkv6.py``) against the reference's
on RWKV6's smoke config (d_model 128, 4 heads of 32, decay LoRA 16,
d_ff 256, chunk 128), CPU, the reference un-jitted.

The chunked form is f32 throughout; the port sums each einsum in f64 and
rounds once, the reference in XLA's f32 order, and the decay LoRA's
``tanh`` is PyTorch's, so they agree to the last bits of f32 (tolerances
printed). Cases: a prompt of 12 positions (one short chunk, clamp at
−64/12), of 200 (a full chunk of 128 and one padded with logw = 0, k =
0), a log decay planted far below the clamp on a quarter of the channels
(the reference's "instant forget"), two decode steps from the prompt's
state, and the channel-mix; fp and quantized projections (half the
blocks W4A4: the time-mix's K = 128 is one INT8 block, the channel-mix
``w_v`` K = 256 one of each). Then the whole RWKV6 smoke model through
``LM`` (``_torch_family_ref``'s model checks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family_ref import (bf16_pair, check_cache_layout, check_caches,
                               check_logits, check_quantized_tree,
                               check_train_logits, jruntime, layer0,
                               make_pair, model_run, pinned_torch, rel_err,
                               tquant)
from repro.configs.base import get_smoke_config as j_smoke
from repro.layers import rwkv6 as JRW
from repro_torch.configs.base import get_smoke_config
from repro_torch.layers import rwkv6 as RW

ARCH = "rwkv6_1p6b"
TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def pinned():
    with pinned_torch():
        yield


@pytest.fixture(scope="module")
def layers():
    """{(kind, quantized): (reference params, the port's)} of layer 0's
    time-mix and channel-mix in the model the model-level checks below
    run (``make_pair``), fp and quantized."""
    pair = make_pair(ARCH)
    fp = jax.tree.map(jnp.asarray, pair.fp_np)
    return {(kind, q): (layer0(pair.jq if q else fp, kind),
                        (pair.tq if q else pair.tfp)["blocks"][0][kind])
            for kind in ("tmix", "cmix") for q in (False, True)}


CFGS = (j_smoke(ARCH), get_smoke_config(ARCH))


@pytest.mark.parametrize("length,clamped", [(12, False), (200, False),
                                            (12, True)],
                         ids=["L12", "L200", "L12-clamp"])
def test_chunked_linear_attn_matches_reference(layers, length, clamped):
    """The chunked form alone on the same bf16 r/k/v and f32 log decay
    (with ``clamped``, a quarter of the channels at −40, far below the
    −64/Q clamp): y and the final state within 1e-4 of their max."""
    jp, tp = layers["tmix", False]
    rng = np.random.default_rng(length + clamped)
    shape = (2, length, 4, 32)
    (jr, tr), (jk, tk), (jv, tv) = (
        bf16_pair(rng.normal(size=shape).astype(np.float32))
        for _ in range(3))
    logw = -np.exp(rng.normal(-2.0, 1.5, size=shape)).astype(np.float32)
    if clamped:
        logw[..., ::4] = -40.0
    with jax.disable_jit():
        wy, ws = JRW._chunked_linear_attn(jr, jk, jv, jnp.asarray(logw),
                                          jp["bonus_u"], 128)
    gy, gs = RW._chunked_linear_attn(tr, tk, tv, torch.from_numpy(logw),
                                     tp["bonus_u"], 128)
    ey, es = rel_err(gy, wy), rel_err(gs, ws)
    print(f"L={length} clamp={clamped}: y error / max {ey:.3e}, "
          f"state {es:.3e}")
    assert gy.shape == wy.shape and gs.shape == ws.shape
    assert np.isfinite(gy.numpy()).all()
    assert ey <= 1e-4 and es <= 1e-4


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w4ax"])
def test_time_mix_prefill_then_decode(layers, quantized):
    """``rwkv6_train`` over 12 positions from a seeded shift, then two
    ``rwkv6_decode`` steps from its state: outputs within 2e-2 of their
    max, the state within 2e-2 of its max, the shifts equal."""
    jp, tp = layers["tmix", quantized]
    jcfg, cfg = CFGS
    rng = np.random.default_rng(7)
    jx, tx = bf16_pair(rng.normal(size=(2, 12, 128)).astype(np.float32))
    jsh, tsh = bf16_pair(rng.normal(size=(2, 1, 128)).astype(np.float32))
    steps = [bf16_pair(rng.normal(size=(2, 1, 128)).astype(np.float32))
             for _ in range(2)]
    quant = tquant() if quantized else None
    with jax.disable_jit(), jruntime():
        wy, wst = JRW.rwkv6_train(jp, jcfg, jx, {"shift_tm": jsh})
        wst = dict(wst, shift_cm=jsh)
        wouts = []
        for js, _ in steps:
            o, wst = JRW.rwkv6_decode(jp, jcfg, js, wst)
            wouts.append(o)
    gy, gst = RW.rwkv6_train(tp, cfg, tx, {"shift_tm": tsh}, quant)
    gst = dict(gst, shift_cm=tsh)
    gouts = []
    for _, ts in steps:
        o, gst = RW.rwkv6_decode(tp, cfg, ts, gst, quant)
        gouts.append(o)
    errs = [rel_err(gy, wy)] + [rel_err(g, w) for g, w in zip(gouts, wouts)]
    es = rel_err(gst["s"], wst["s"])
    print(f"{'w4ax' if quantized else 'fp'}: output error / max (prefill, "
          f"decode 1, 2) {errs}; state {es:.3e}")
    assert max(errs) <= TOL and es <= TOL
    assert rel_err(gst["shift_tm"], wst["shift_tm"]) == 0.0


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w4ax"])
def test_channel_mix(layers, quantized):
    """``rwkv6_cmix`` over 12 positions from a seeded shift: the output
    within 2e-2 of its max (bit for bit but where a bf16 matmul or an
    act-quant code differs), the new shift equal."""
    jp, tp = layers["cmix", quantized]
    rng = np.random.default_rng(8)
    jx, tx = bf16_pair(rng.normal(size=(2, 12, 128)).astype(np.float32))
    jsh, tsh = bf16_pair(rng.normal(size=(2, 1, 128)).astype(np.float32))
    quant = tquant() if quantized else None
    with jax.disable_jit(), jruntime():
        wy, wsh = JRW.rwkv6_cmix(jp, CFGS[0], jx, jsh)
    gy, gsh = RW.rwkv6_cmix(tp, CFGS[1], tx, tsh, quant)
    err = rel_err(gy, wy)
    print(f"{'w4ax' if quantized else 'fp'}: channel-mix error / max "
          f"{err:.3e}")
    assert err <= TOL and rel_err(gsh, wsh) == 0.0


# ------------------------------------------------------- the whole model

@pytest.fixture(scope="module")
def run():
    return model_run("rwkv6_1p6b")


def test_model_quantized_tree_is_the_reference_s(run):
    check_quantized_tree(run)


def test_model_train_logits(run):
    check_train_logits(run)


def test_model_prefill_and_decode_logits(run):
    check_logits(run)


def test_model_caches(run):
    check_caches(run)


def test_model_cache_layout_is_the_reference_s(run):
    check_cache_layout(run)
