"""Shared set-up of the tests that hold the port's other model families
(Zamba2, RWKV-6, Llama-3.2-Vision, HuBERT) to the JAX reference on the
CPU: one model per smoke config (the port's fp init, quantized by the
reference, carried into the port), the reference's quantized runtime,
XLA's trigonometry in the port's RoPE, and one PyTorch thread.

The model-level checks (``model_run`` and the ``check_*`` functions)
are shared too: ``test_torch_mamba2.py`` runs them on Zamba2,
``test_torch_rwkv6.py`` on RWKV-6 (each file then compiles the
reference's eager ops of its family once, for its layer and its model
tests) and ``test_torch_families.py`` on the VLM and the encoder. What
they hold: the port's ``LM.quantize`` of the reference's fp weights
builds the reference's quantized tree byte for byte; ``train_logits``,
``prefill`` of 2 × 12 tokens and 2 ``decode`` steps (the reference's
greedy tokens fed to both) within 2e-2·max|logit| (measured, printed:
0 but for Zamba2's decode steps, 4.4e-8 and 1.1e-5; a last-bit f32
difference from sums in another order, or from PyTorch's f32
``tanh``/``log1p``, can move a bf16 rounding and an int4 code: on other
seeded weights one bf16 step of one flash-attention output moved
HuBERT's train logits by 2.4e-2); every int4 cache (the hybrid's shared attention, the
VLM's self layers) byte for byte after the prefill and the decode steps;
the recurrent states and the bf16 image K/V within 2e-2 of their max;
the reference's fresh cache carried by ``convert.cache_from_jax`` in
the port's layout.

Not a test module (no ``test_`` prefix): the three test files import it.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.core import qlinear as JQL
from repro.models.lm import LM as JLM
from repro.models.lm import QuantConfig as JQuantConfig
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax, to_torch
from repro_torch.models.lm import LM, QuantConfig

BATCH, PROMPT, MAX_LEN, STEPS = 2, 12, 24, 2
TOL = 2e-2
# half the blocks W4A4: a K of 256 (d_inner, d_ff) keeps an INT8 block,
# so both GEMMs run; K = 128 (d_model) is one INT8 block
INT4_FRACTION = 0.5
GATE = 0.5            # the VLM's cross gate (0 at init: tanh(0) = 0)


@contextlib.contextmanager
def pinned_torch():
    """One PyTorch thread, and XLA's f32 cos/sin in the port's RoPE
    (XLA's CPU trig differs from PyTorch's in the last bit on ~5 % of
    angles)."""
    def xla(fn):
        return lambda t: torch.from_numpy(np.array(fn(t.numpy())))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "cos", xla(jnp.cos))
        mp.setattr(torch, "sin", xla(jnp.sin))
        yield
    torch.set_num_threads(n)


def jquant(fraction=INT4_FRACTION, kv4=True):
    return JQuantConfig(impl="ref", int4_fraction=fraction, kv4=kv4)


def tquant(fraction=INT4_FRACTION, kv4=True):
    return QuantConfig(impl="ref", int4_fraction=fraction, kv4=kv4)


def jruntime(fraction=INT4_FRACTION):
    """The reference's dispatcher runtime for a layer called alone."""
    return JQL.quant_runtime(JQL.QuantRuntime(
        int4_fraction=fraction, schedule="split", impl="ref"))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@dataclasses.dataclass
class Pair:
    """One smoke model in both packages: the reference's fp params
    (stacked numpy), its quantized params (JAX), the port's copies."""
    arch: str
    jcfg: object
    cfg: object
    fp_np: dict
    jq: dict
    tq: dict
    tfp: dict


def port_fp_params(cfg, seed: int = 0) -> dict:
    """The port's own fp weights of ``cfg`` (``LM.init_fp``: ``LM.init``'s
    draws before quantization, the reference's distributions), the VLM's
    cross gates at ``GATE``."""
    params = LM(cfg).init_fp(seed, "cpu")
    for cb in params.get("cross_blocks", []):
        cb["gate"].fill_(GATE)
    return params


def _stacked(tree):
    """The port's fp tree → the reference's layout in numpy: each list of
    per-layer dicts (``blocks``, ``cross_blocks``) one stacked tree."""
    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack([x.numpy() for x in xs])

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        return x.numpy()
    return {k: stack(*v) if isinstance(v, list) else leaf(v)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def make_pair(arch: str, seed: int = 0, fraction=INT4_FRACTION) -> Pair:
    """The port's fp weights of the smoke config at ``seed``
    (:func:`port_fp_params`) in the reference's stacked layout, quantized
    by the reference's ``LM.quantize`` at ``fraction``, both carried into
    the port with ``params_from_jax``; made once a process (callers must
    not modify it). The weights are drawn by the port because the
    reference's ``jax.random`` init costs seconds of eager compiles."""
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    fp_np = _stacked(port_fp_params(cfg, seed))
    params = jax.tree.map(jnp.asarray, fp_np)
    jq, _ = JLM(jcfg, quant=jquant(fraction)).quantize(
        params, jax.tree.map(lambda a: None, params))
    return Pair(arch, jcfg, cfg, fp_np, jq,
                params_from_jax(np_tree(jq), device="cpu"),
                params_from_jax(fp_np, device="cpu"))


def extra_inputs(cfg, batch: int, seq: int, seed: int = 5):
    """(reference extra, port extra): seeded image embeddings (vlm) or
    frames (audio), f32, the same numbers; (None, None) otherwise."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        key, shape = "image_embeds", (batch, cfg.num_image_tokens,
                                      cfg.d_model)
    elif cfg.family == "audio":
        key, shape = "frames", (batch, seq, cfg.d_model)
    else:
        return None, None
    a = rng.normal(size=shape).astype(np.float32)
    return {key: jnp.asarray(a)}, {key: torch.from_numpy(a)}


def bf16_pair(a: np.ndarray):
    """f32 numpy → (JAX bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, to_torch(np.asarray(j), "cpu")


def to_np(t) -> np.ndarray:
    """A JAX or torch array → f32 numpy (bf16 widened)."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def rel_err(got, want) -> float:
    got, want = to_np(got), to_np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def model_run(arch: str):
    """Both packages' train logits, prefill and decode logits and caches
    on one model of the family (``make_pair``): ``BATCH`` × ``PROMPT``
    seeded tokens, ``STEPS`` decode steps fed the reference's greedy
    tokens; once a process."""
    pair = make_pair(arch)
    cfg = pair.cfg
    rng = np.random.default_rng(11)
    tokens = rng.integers(1, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    jextra, textra = extra_inputs(cfg, BATCH, PROMPT)
    jlm, lm = JLM(pair.jcfg, quant=jquant()), LM(cfg, tquant())
    ttok = torch.from_numpy(tokens).long()
    ref, port = {"logits": [], "caches": []}, {"logits": [], "caches": []}
    with jax.disable_jit():
        ref["train"] = np.asarray(jlm.train_logits(
            pair.jq, jnp.asarray(tokens), jextra)[0])
    port["train"] = lm.train_logits(pair.tq, ttok, textra)[0].numpy()
    if cfg.has_decode:
        with jax.disable_jit():
            cache = jlm.init_cache(BATCH, MAX_LEN)
            ref["init_cache"] = np_tree(cache)
            lg, cache = jlm.prefill(pair.jq, jnp.asarray(tokens), cache,
                                    jextra)
            ref["caches"].append(np_tree(cache))
            feed = []
            for _ in range(STEPS):
                ref["logits"].append(np.asarray(lg[:, -1]))
                tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
                feed.append(np.asarray(tok))
                lg, cache = jlm.decode(pair.jq, tok[:, None], cache)
            ref["logits"].append(np.asarray(lg[:, -1]))
            ref["caches"].append(np_tree(cache))
        cache = lm.init_cache(BATCH, MAX_LEN, device="cpu")
        port["init_cache"] = cache
        lg, cache = lm.prefill(pair.tq, ttok, cache, textra)
        port["caches"].append(_snapshot(cache))
        for tok in feed:
            port["logits"].append(lg[:, -1].numpy())
            lg, cache = lm.decode(
                pair.tq, torch.from_numpy(tok).long()[:, None], cache)
        port["logits"].append(lg[:, -1].numpy())
        port["caches"].append(_snapshot(cache))
    return pair, ref, port


def _snapshot(cache: dict) -> dict:
    return {k: [{n: t.clone() for n, t in layer.items()} for layer in v]
            for k, v in cache.items()}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


def check_quantized_tree(run):
    """The port's ``LM.quantize`` of the reference's fp weights equals the
    reference's quantized tree carried across: the same keys, shapes,
    dtypes and bytes (packed W4, scales, the f32 tensors left alone)."""
    pair = run[0]
    built = dict(_flat(LM(pair.cfg, tquant()).quantize(pair.tfp)))
    want = dict(_flat(pair.tq))
    assert sorted(built, key=str) == sorted(want, key=str)
    for path, t in want.items():
        got = built[path]
        assert got.dtype == t.dtype and got.shape == t.shape, path
        assert torch.equal(got, t), path
    packed = [p for p in want if p[-1] == "w_packed"]
    print(f"{pair.arch}: {len(want)} tensors, {len(packed)} packed")
    assert packed


def check_train_logits(run):
    pair, ref, port = run
    assert port["train"].shape == ref["train"].shape
    err = rel_err(port["train"], ref["train"])
    print(f"{pair.arch}: train_logits error / max|logit| {err:.3e}")
    assert np.isfinite(port["train"]).all() and err <= TOL


def check_logits(run):
    pair, ref, port = run
    if not pair.cfg.has_decode:
        with pytest.raises(ValueError, match="encoder-only"):
            LM(pair.cfg, tquant()).prefill(pair.tq, None, {})
        return
    errs = [rel_err(g, w) for g, w in zip(port["logits"], ref["logits"])]
    print(f"{pair.arch}: prefill + decode logit error / max|logit| {errs}")
    assert len(errs) == STEPS + 1 and max(errs) <= TOL


def check_caches(run):
    """After the prefill and after the decode steps: every int4 cache
    byte for byte (the hybrid's shared attention, one per group; the
    VLM's self layers), the lengths equal, the recurrent states and the
    bf16 image K/V (the port's head-major) within 2e-2 of their max."""
    pair, ref, port = run
    if not pair.cfg.has_decode:
        assert port["caches"] == [] and port["logits"] == []
        return
    for stage, (got, want) in enumerate(zip(port["caches"], ref["caches"])):
        assert sorted(got) == sorted(want)
        for kind, layers in got.items():
            for i, layer in enumerate(layers):
                for name, t in layer.items():
                    w = np.asarray(want[kind][name][i])
                    if kind == "cross_kv":        # the port's is head-major
                        t = t.transpose(1, 2)
                    tag = (pair.arch, stage, kind, i, name)
                    assert tuple(t.shape) == w.shape, tag
                    if t.dtype == torch.uint8 or name == "length":
                        np.testing.assert_array_equal(t.numpy(), w,
                                                      err_msg=str(tag))
                    elif name.endswith(("_scale", "_zero")):
                        assert np.array_equal(t.numpy(), w), tag
                    else:
                        err = rel_err(t, w) if np.abs(
                            to_np(w)).max() else float(t.abs().max())
                        print(f"{tag}: error / max {err:.3e}")
                        assert err <= TOL, tag
    packed = [k for k, v in port["caches"][-1].items()
              if v and "k_packed" in v[0]]
    print(f"{pair.arch}: int4 caches held byte for byte: {packed}")
    assert packed == {"zamba2_2p7b": ["shared_attn"],
                      "llama3p2_vision_90b": ["attn"]}.get(pair.arch, [])


def check_cache_layout(run):
    """The reference's fresh cache carried by ``cache_from_jax`` has the
    port's ``init_cache`` layout: the same kinds, per-layer (or
    per-group) entries, names, shapes and dtypes."""
    pair, ref, port = run
    if not pair.cfg.has_decode:
        assert LM(pair.cfg, tquant()).init_cache(2, 8, device="cpu") == {}
        return
    conv = cache_from_jax(ref["init_cache"], device="cpu")
    mine = port["init_cache"]
    assert sorted(conv) == sorted(mine)
    for kind in mine:
        assert len(conv[kind]) == len(mine[kind]), kind
        for a, b in zip(conv[kind], mine[kind]):
            assert sorted(a) == sorted(b)
            for name in a:
                assert a[name].shape == b[name].shape, (kind, name)
                assert a[name].dtype == b[name].dtype, (kind, name)


def layer0(tree, key: str):
    """Layer 0 of a reference stack (``tree["blocks"][key]``)."""
    return jax.tree.map(lambda a: a[0], tree["blocks"][key])
