"""The port's Mamba2 layer (``layers/mamba2.py``) against the reference's
on Zamba2's smoke config (d_model 128, d_inner 256, 8 heads of 32, state
16, chunk 32), CPU, the reference un-jitted.

Exact: the causal conv (bf16, rounded after every product and sum) and
XLA's cumulative sum. Within tolerances, each printed: the chunked SSD
and the layer's output and state, because the f32 sums of the SSD
einsums run in another order (f64 here, rounded once) and the
``log1p`` of softplus is PyTorch's — last-bit f32 differences that the
bf16 roundings after them (the decay, ``dt``, the output) pass on now and
then as one bf16 step. Prompts of 12 (one short chunk: the model's
shapes, whose eager ops the reference compiles once for both levels)
and, for the chunked scan, 40 (a full chunk and one padded with dt = 0)
positions; fp and
quantized projections (half the blocks W4A4: ``in_proj`` K = 128 is one
INT8 block, ``out_proj`` K = 256 one of each). Then the whole Zamba2
smoke model through ``LM`` (``_torch_family_ref``'s model checks: the
shared attention's int4 cache byte for byte, 2 groups).
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
                               tquant, to_np)
from repro.configs.base import get_smoke_config as j_smoke
from repro.layers import mamba2 as JM2
from repro_torch.configs.base import get_smoke_config
from repro_torch.layers import common as C
from repro_torch.layers import mamba2 as M2
from repro_torch.layers import mlp as MLP

ARCH = "zamba2_2p7b"
TOL = 2e-2
LENGTHS = (12, 40)


@pytest.fixture(scope="module", autouse=True)
def pinned():
    with pinned_torch():
        yield


@pytest.fixture(scope="module")
def layers():
    """{quantized: (reference layer-0 Mamba2 params, the port's)} of the
    model the model-level checks below run (``make_pair``), fp and
    quantized."""
    pair = make_pair(ARCH)
    return {False: (layer0(jax.tree.map(jnp.asarray, pair.fp_np), "mamba"),
                    pair.tfp["blocks"][0]["mamba"]),
            True: (layer0(pair.jq, "mamba"), pair.tq["blocks"][0]["mamba"])}


def test_causal_conv_is_the_reference_s_bit_for_bit(layers):
    """bf16 conv over 40 positions of 288 channels with the layer's taps:
    every output bit equal."""
    jp, tp = layers[False]
    rng = np.random.default_rng(0)
    jx, tx = bf16_pair(rng.normal(size=(2, 40, 288)).astype(np.float32))
    with jax.disable_jit():
        want = JM2._causal_conv(jx, jp["conv_w"], jp["conv_b"])
    got = M2._causal_conv(tx, tp["conv_w"], tp["conv_b"])
    np.testing.assert_array_equal(to_np(got), to_np(want))


@pytest.mark.parametrize("n", [5, 16, 40, 300])
def test_cumsum_is_xla_s_bit_for_bit(n):
    """``jnp.cumsum`` on the CPU (XLA's blocks of 16) along axis 2 of a
    [2, 3, n, 4] f32 tensor, every bit."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(2, 3, n, 4))
         * rng.uniform(0.1, 10, size=(2, 3, n, 4))).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=2))
    got = C.cumsum_xla(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)


def test_softplus_and_sigmoid_against_xla():
    """``jax.nn.sigmoid`` bit for bit; ``jax.nn.softplus`` within two f32
    ulps (its ``log1p`` is PyTorch's; measured: 93.5 % of 20,000
    arguments bit-equal, 2 ulps at most), equal on most arguments."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=20_000) * 4).astype(np.float32)
    with jax.disable_jit():
        sp = np.asarray(jax.nn.softplus(jnp.asarray(x)))
        sg = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(MLP.sigmoid_f32(t).numpy(), sg)
    got = MLP.softplus_f32(t).numpy()
    same = float((got == sp).mean())
    ulps = np.abs(got.view(np.int32) - sp.view(np.int32)).max()
    print(f"softplus: share bit-equal {same:.4f}, most ulps apart {ulps}")
    assert ulps <= 2 and same > 0.8


@pytest.mark.parametrize("length", LENGTHS)
def test_ssd_chunked_matches_reference(layers, length):
    """The chunked scan alone on the same bf16 x, B, C and f32 dt: y and
    the final state within 1e-3 of their max (f32 sums in another
    order; bf16 roundings of decay and C·B passed on)."""
    jp, tp = layers[False]
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(length)
    h, p, n = 8, cfg.ssm_head_dim, cfg.ssm_state
    jx, tx = bf16_pair(rng.normal(size=(2, length, h, p)).astype(np.float32))
    jb, tb = bf16_pair(rng.normal(size=(2, length, n)).astype(np.float32))
    jc, tc = bf16_pair(rng.normal(size=(2, length, n)).astype(np.float32))
    dt = rng.uniform(0.001, 0.2, size=(2, length, h)).astype(np.float32)
    with jax.disable_jit():
        wy, ws = JM2._ssd_chunked(jx, jnp.asarray(dt), jp["A_log"], jb, jc,
                                  cfg.ssm_chunk)
    gy, gs = M2._ssd_chunked(tx, torch.from_numpy(dt), tp["A_log"], tb, tc,
                             cfg.ssm_chunk)
    ey, es = rel_err(gy, wy), rel_err(gs, ws)
    print(f"L={length}: SSD y error / max {ey:.3e}, state {es:.3e}")
    assert gy.shape == wy.shape and gs.shape == ws.shape
    assert ey <= 1e-3 and es <= 1e-3


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w4ax"])
@pytest.mark.parametrize("length", [12])
def test_layer_prefill_state_and_decode(layers, quantized, length):
    """``mamba2_train(return_state=True)`` on a prompt, then two
    ``mamba2_decode`` steps from its state, each side from its own: the
    outputs within 2e-2 of max|out|, the SSM state within 2e-2 of its max
    and the conv state (bf16 in_proj outputs) equal but for a bf16 step
    where act-quant codes moved."""
    jp, tp = layers[quantized]
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    rng = np.random.default_rng(100 + length)
    ju, tu = bf16_pair(rng.normal(size=(2, length, 128)).astype(np.float32))
    steps = [bf16_pair(rng.normal(size=(2, 1, 128)).astype(np.float32))
             for _ in range(2)]
    quant = tquant() if quantized else None
    with jax.disable_jit(), jruntime():
        wy, wst = JM2.mamba2_train(jp, jcfg, ju, return_state=True)
        wouts = []
        for js, _ in steps:
            o, wst2 = JM2.mamba2_decode(jp, jcfg, js, wst)
            wouts.append(o)
            wst = wst2
    gy, gst = M2.mamba2_train(tp, cfg, tu, quant, return_state=True)
    gouts = []
    for _, ts in steps:
        o, gst = M2.mamba2_decode(tp, cfg, ts, gst, quant)
        gouts.append(o)
    errs = [rel_err(gy, wy)] + [rel_err(g, w) for g, w in zip(gouts, wouts)]
    es = rel_err(gst["ssm"], wst["ssm"])
    ec = rel_err(gst["conv"], wst["conv"])
    print(f"{'w4ax' if quantized else 'fp'} L={length}: output error / max "
          f"(prefill, decode 1, 2) {errs}; ssm state {es:.3e}, conv state "
          f"{ec:.3e}")
    assert gy.shape == wy.shape and gst["conv"].shape == wst["conv"].shape
    assert max(errs) <= TOL and es <= TOL and ec <= TOL


# ------------------------------------------------------- the whole model

@pytest.fixture(scope="module")
def run():
    return model_run("zamba2_2p7b")


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
