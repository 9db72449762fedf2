"""The port's host sampler against the JAX reference's (CPU).

The batched sampler reproduces the reference's jitted JAX sampler
(``Engine._make_sample_fn``): JAX's threefry keys, bits and uniforms
bit for bit, ``jax.lax.top_k``'s order, and the same tokens; only the
Gumbel noise's f32 ``log`` is numpy's instead of XLA's (a few ulps apart
on about a third of uniforms), so tokens are held equal on many rows of
bf16-valued logits, whose ties inside the top k are common. The
speculative verifier's rejection sampler is the reference's f64 numpy
code and must give identical results. Last, every engine path hands the
sampler the reference's positions, and a stochastic engine replays its
tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine import Engine as JEngine
from repro.serving.engine import _reject_sample as j_reject_sample
from repro.serving.engine import _spec_probs as j_spec_probs
from repro_torch.configs import get_smoke_config
from repro_torch.models.lm import LM, QuantConfig
from repro_torch.serving import sampling as S
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import Engine, EngineConfig

TINY = np.finfo(np.float32).tiny


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side runs tiny shapes: PyTorch's intra-op threads would
    only contend with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_keys(rids, positions):
    key0 = jax.random.PRNGKey(0)
    return jax.vmap(lambda r, p: jax.random.fold_in(
        jax.random.fold_in(key0, r), p))(jnp.asarray(rids, jnp.int32),
                                         jnp.asarray(positions, jnp.int32))


@pytest.mark.parametrize("k", [1, 7, 64, 1024])
def test_threefry_bits_and_uniforms_match_jax(k):
    rng = np.random.default_rng(k)
    rids = np.concatenate([[0, 1, 2**31 - 1], rng.integers(0, 2**31, 61)])
    pos = np.concatenate([[0, 5, 2**31 - 1], rng.integers(0, 2**20, 61)])
    jkeys = _jax_keys(rids, pos)
    keys = S.sample_keys(rids, pos)
    assert keys.dtype == np.uint32
    np.testing.assert_array_equal(keys, np.asarray(jkeys))
    bits = jax.vmap(lambda kk: jax.random.bits(kk, (k,)))(jkeys)
    np.testing.assert_array_equal(S.random_bits(keys, k), np.asarray(bits))
    u = jax.vmap(lambda kk: jax.random.uniform(
        kk, (k,), minval=TINY, maxval=1.0))(jkeys)
    mine = S.uniform(keys, k)
    assert mine.dtype == np.float32
    np.testing.assert_array_equal(mine.view(np.uint32),
                                  np.asarray(u).view(np.uint32))


def _bf16_logits(rng, n, v, scale=3.0):
    """bf16-valued f32 logits, as the lm head gives them, with exact ties
    at the row maximum and signed zeros."""
    x = (rng.standard_normal((n, v)) * scale).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    x[:, 3] = x.max(axis=1)
    x[::5, 7] = x[::5, 3]
    x[::7, 10], x[::7, 11], x[::7, 12] = 0.0, -0.0, 0.0
    return x


@pytest.mark.parametrize("k", [1, 5, 40, 64])
def test_top_k_matches_lax(k):
    x = _bf16_logits(np.random.default_rng(k), 256, 300, scale=0.05)
    tv, ti = jax.lax.top_k(jnp.asarray(x), k)
    mv, mi = S.top_k(x, k)
    np.testing.assert_array_equal(mi, np.asarray(ti))
    np.testing.assert_array_equal(mv.view(np.uint32),
                                  np.asarray(tv).view(np.uint32))


@pytest.mark.parametrize("n,v,max_top_k", [(8192, 512, 64),
                                           (512, 32000, 100)])
def test_sample_batch_matches_reference(n, v, max_top_k):
    """Rows mixing greedy and stochastic requests, per-row top_k and
    temperature, ties inside the top k: the reference's jitted sampler
    and the port's give the same token on every row."""
    rng = np.random.default_rng(v)
    logits = _bf16_logits(rng, n, v)
    temps = np.where(rng.random(n) < 0.25, 0.0,
                     rng.uniform(0.2, 1.6, n)).astype(np.float32)
    topks = rng.integers(1, max_top_k + 1, n)
    rids = rng.integers(0, 5000, n)
    pos = rng.integers(0, 8192, n)
    kmax = min(1 << (int(topks.max()) - 1).bit_length(), v)
    fn = JEngine._make_sample_fn(None, kmax)
    ref = np.asarray(fn(jnp.asarray(logits), jnp.asarray(rids, jnp.int32),
                        jnp.asarray(pos, jnp.int32), jnp.asarray(temps),
                        jnp.asarray(topks, jnp.int32)))
    mine = S.sample_batch(logits, rids, pos, temps, topks)
    assert (mine == ref).all(), int((mine != ref).sum())
    hot = temps > 0
    # the stochastic rows are not all their argmax: the draw is live
    assert (mine[hot] != logits[hot].argmax(axis=1)).mean() > 0.3


@pytest.mark.parametrize("temp,top_k,drafted", [
    (0.8, 40, 3), (0.8, 40, None), (1.3, 5, 0), (0.05, 512, 7),
    (0.7, 1, 3), (2.0, 512, None)])
def test_spec_probs_and_reject_sample_identical(temp, top_k, drafted):
    rng = np.random.default_rng(top_k)
    for row_i, row in enumerate(_bf16_logits(rng, 24, 512)):
        np.testing.assert_array_equal(S.spec_probs(row, temp, top_k),
                                      j_spec_probs(row, temp, top_k))
        for pos in (0, 17, 4095):
            rid = 3 * row_i + 1
            assert (S.reject_sample(row, temp, top_k, drafted, rid, pos)
                    == j_reject_sample(row, temp, top_k, drafted, rid, pos))


# --------------------------------------------- the engine's sampler calls

ENGINE = dict(max_batch=4, num_pages=64, page_size=8, max_pages_per_seq=16,
              prefill_chunk_tokens=24, kv_range=4.0, temperature=0.8,
              top_k=8)
PATHS = {   # the reference's positions: len(prompt) for a finished
    # prefill, total_len for a decode row — the same number before the
    # token is recorded
    "unified": {}, "split_chunked": dict(unified_step=False),
    "whole": dict(prefill_mode="whole", decode_attention="gather"),
}


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("llama3_8b")
    return cfg, LM(cfg).init(seed=0, device="cpu")


def _serve(smoke, kw, log):
    cfg, params = smoke
    eng = Engine(cfg, params, QuantConfig(impl="ref"),
                 EngineConfig(**{**ENGINE, **kw}), device="cpu")
    inner = eng._sample_batch

    def spy(logits, reqs, positions):
        log.append(([r.request_id for r in reqs], list(positions),
                    [r.total_len for r in reqs],
                    [len(r.generated) for r in reqs]))
        return inner(logits, reqs, positions)

    eng._sample_batch = spy
    rng = np.random.default_rng(2)
    for i, n in enumerate((30, 9, 17)):
        eng.add_request(i, rng.integers(1, cfg.vocab_size, n).tolist(), 5)
    done = eng.run()
    assert eng.counters()["internal_errors"] == 0
    return {r.request_id: list(r.generated) for r in done}


@pytest.mark.parametrize("path", list(PATHS))
def test_every_path_passes_positions(smoke, path):
    log = []
    toks = _serve(smoke, PATHS[path], log)
    assert sorted(toks) == [0, 1, 2] and all(len(t) == 5
                                             for t in toks.values())
    firsts = decodes = 0
    for rids, positions, total, ngen in log:
        assert positions == total, (path, rids, positions, total)
        firsts += sum(g == 0 for g in ngen)
        decodes += sum(g > 0 for g in ngen)
    assert firsts == 3 and decodes == 3 * 4
    # keyed by (request id, position): a second run replays every token,
    # and the draw is not the argmax
    assert _serve(smoke, PATHS[path], []) == toks
    greedy = _serve(smoke, dict(PATHS[path], temperature=0.0), [])
    assert greedy != toks


def test_sampling_params_validation():
    with pytest.raises(ValueError, match="temperature"):
        SamplingParams(temperature=-0.1)
    with pytest.raises(ValueError, match="top_k"):
        SamplingParams(top_k=0)
    p = SamplingParams(max_new_tokens=3, temperature=0.5, top_k=7,
                       speculation=2)
    assert (p.temperature, p.top_k, p.speculation) == (0.5, 7, 2)
