"""The port's other model families through ``LM`` against the reference's
(CPU, plain kernel versions, the reference un-jitted), at their smoke
configs: Llama-3.2-Vision (vlm, the cross gates set to 0.5 in both
packages: at init tanh(0) = 0 leaves the cross path unused) and HuBERT
(audio encoder) model by model with ``_torch_family_ref``'s checks
(Zamba2 and RWKV-6 run them in ``test_torch_mamba2.py`` and
``test_torch_rwkv6.py``); the four configurations field for field; for
every decoder family, the port's own fp prefill + decode against its own
``train_logits`` at 0.05·max (the reference's
``tests/models/test_decode_parity.py`` property); the VLM's
cross-attention pieces alone; and the refusals (an encoder has no
decode; a mesh and FMPQ plans are not ported for these families).

One model a family, drawn by the port's init and quantized by the
reference (half the blocks W4A4, so every projection of K ≥ 256 runs
W4A4 and W4A8), carried across with ``convert.params_from_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family_ref import (TOL, bf16_pair, check_cache_layout,
                               check_caches, check_logits,
                               check_quantized_tree, check_train_logits,
                               extra_inputs, jruntime, make_pair, model_run,
                               pinned_torch, port_fp_params, rel_err, tquant)
from repro.configs import base as JB
from repro.layers import attention as JATT
from repro.models import lm as JLMM
from repro_torch.configs import base as B
from repro_torch.layers import attention as ATT
from repro_torch.models import lm as LMM
from repro_torch.models.lm import LM

ARCHS = ("zamba2_2p7b", "rwkv6_1p6b", "llama3p2_vision_90b", "hubert_xlarge")
DECODERS = ARCHS[:3]


@pytest.fixture(scope="module", autouse=True)
def pinned():
    with pinned_torch():
        yield


@pytest.fixture(scope="module", params=("llama3p2_vision_90b",
                                        "hubert_xlarge"))
def run(request):
    return model_run(request.param)


def test_quantized_tree_is_the_reference_s(run):
    check_quantized_tree(run)


def test_train_logits(run):
    check_train_logits(run)


def test_prefill_and_decode_logits(run):
    check_logits(run)


def test_caches(run):
    check_caches(run)


def test_cache_layout_is_the_reference_s(run):
    check_cache_layout(run)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, smoke):
    """The four configurations (and their smoke versions) field for field
    (a field the port leaves out is at the reference's default: ``dtype``
    and ``tie_embeddings``; ``rwkv_mix_lora``, which no code of either
    package reads, is left out at any value) and in their derived
    properties; registered in ``ARCH_IDS``."""
    get, jget = ((B.get_smoke_config, JB.get_smoke_config) if smoke
                 else (B.get_config, JB.get_config))
    cfg, jcfg = get(arch), jget(arch)
    kept = {f.name for f in dataclasses.fields(B.ModelConfig)}
    for f in dataclasses.fields(JB.ModelConfig):
        if f.name in kept:
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        elif f.name != "rwkv_mix_lora":
            assert getattr(jcfg, f.name) == f.default, f.name
    for prop in ("q_dim", "kv_dim", "num_self_layers", "sub_quadratic",
                 "has_decode"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert arch in B.ARCH_IDS


@pytest.mark.parametrize("arch", DECODERS)
def test_own_decode_matches_own_train_forward(arch):
    """The port alone, fp weights and the bf16 cache: ``prefill`` of 24
    tokens and 2 ``decode`` steps against ``train_logits`` of all 26, at
    0.05·max|logit| (the reference's own decode-parity property)."""
    cfg = B.get_smoke_config(arch)
    params = port_fp_params(cfg, 0)
    lm = LM(cfg)
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 26)))
    _, extra = extra_inputs(cfg, 2, 26)
    full = lm.train_logits(params, tokens, extra)[0]
    tol = 0.05 * float(full.abs().max())
    cache = lm.init_cache(2, 32, device="cpu")
    lg, cache = lm.prefill(params, tokens[:, :24], cache, extra)
    errs = [float((lg[:, 0] - full[:, 23]).abs().max())]
    for i in range(2):
        lg, cache = lm.decode(params, tokens[:, 24 + i:25 + i], cache)
        errs.append(float((lg[:, 0] - full[:, 24 + i]).abs().max()))
    print(f"{arch}: |decode − train| {errs}, bound {tol:.4f}")
    assert max(errs) < tol


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w4ax"])
def test_cross_attention_pieces(quantized):
    """The VLM's cross block alone: ``attention_train(kv_override=)``
    over 16 image embeddings (no RoPE, every key visible), the image K/V
    of the prefill, and the decode step against them, within 2e-2 of
    their max."""
    pair = make_pair("llama3p2_vision_90b")
    jp = jax.tree.map(lambda a: a[0], (pair.jq if quantized else jax.tree.map(
        jnp.asarray, pair.fp_np))["cross_blocks"]["attn"])
    tp = (pair.tq if quantized else pair.tfp)["cross_blocks"][0]["attn"]
    jcfg, cfg = pair.jcfg, pair.cfg
    rng = np.random.default_rng(3)
    jx, tx = bf16_pair(rng.normal(size=(2, 12, 128)).astype(np.float32))
    jimg, timg = bf16_pair(rng.normal(size=(2, 16, 128)).astype(np.float32))
    jt, tt = bf16_pair(rng.normal(size=(2, 1, 128)).astype(np.float32))
    quant = tquant() if quantized else None
    with jax.disable_jit(), jruntime():
        wa = JATT.attention_train(jp, jcfg, jx, kv_override=jimg)
        wkv = JLMM._cross_kv(jcfg, jp, jimg)
        wd = JLMM._cross_decode(jcfg, jp, jt, wkv)
    ga = ATT.attention_train(tp, cfg, tx, quant=quant, kv_override=timg)
    gkv = ATT.cross_kv(tp, cfg, timg, quant)
    gd = LMM.cross_decode(cfg, tp, tt, gkv, quant)
    errs = {"train": rel_err(ga, wa),
            "k": rel_err(gkv["k"].transpose(1, 2), wkv["k"]),
            "v": rel_err(gkv["v"].transpose(1, 2), wkv["v"]),
            "decode": rel_err(gd, wd)}
    print(f"{'w4ax' if quantized else 'fp'} cross attention error / max "
          f"{errs}")
    assert max(errs.values()) <= TOL


@pytest.mark.parametrize("arch", DECODERS[:1] + ("hubert_xlarge",))
def test_mesh_and_plans_refused(arch):
    """``LM.init(mesh=)`` and FMPQ plans are the dense and moe families'
    only, refused with the ROADMAP items that would add them."""
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.core import fmpq as F
    from repro_torch.configs.base import get_smoke_config
    cfg = get_smoke_config(arch)
    lm = LM(cfg, tquant())
    with pytest.raises(NotImplementedError, match="item 16"):
        lm.init(seed=0, device="cpu",
                mesh=Mesh(shape={"data": 1, "model": 2}, model_rank=0))
    params = lm.init(seed=0, device="cpu")
    plan = F.plan_fmpq(np.ones(cfg.d_model))
    with pytest.raises(NotImplementedError, match="item 17"):
        lm.quantize(params, [{"wq": plan}] * len(params["blocks"]))
    with pytest.raises(NotImplementedError, match="item 16"):
        lm.axes(params)
