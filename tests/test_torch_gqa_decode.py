"""The decode attention ops at GQA groups outside {1, 2, 4, 8} (CPU, plain
versions): Qwen2.5-32B has G = 40/8 = 5, StarCoder2-15B G = 48/4 = 12.

The plain versions of K6 (dense paged decode), K8 (work-queue decode) and
K10 (contiguous decode) are held to the reference's oracles at G ∈ {3, 5,
12}, as ``test_torch_attention_baselines.py`` holds them at the powers of
two (1e-4·max(1, max|ref|): other summation orders and ``exp``). The
launch planners give the decode kernels 16- or 32-row tiles when G > 8;
``test_torch_card.py`` holds the kernels on those tiles to their plain
versions bit for bit. The engine on the StarCoder2-shaped model (G = 12)
runs the plain K8, K6 and K10 at that group inside a served workload,
held to the JAX engine as ``test_torch_archs.py`` holds the Qwen2.5-shaped
one (every forward's logits within 2e-2·max|logit|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import kv4_attention as KA
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import ref as R
from repro_torch.serving import kv_cache as KVC
from test_torch_archs import (ENGINE_CONFIGS, SHAPES,  # noqa: F401
                              build_model, check_engine_pair, f32_gather,
                              xla_trig)
from test_torch_attention_baselines import (J_K6, J_K8, J_K10, _close,
                                            _k6_case, _k10_case, _t)

GROUPS = [  # (hq, hkv): G = 3, 5, 12
    (6, 2), (10, 2), (24, 2),
]


@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_paged_decode_any_group(hq, hkv):
    args = _k6_case(np.random.default_rng(hq), hq, hkv, 128, 16,
                    [40, 17, 1], 1)
    want = J_K6(*[jnp.asarray(a) for a in args])
    got = OPS.paged_kv4_decode_attention(*[_t(a) for a in args])
    assert got.shape == (3, hq, 128)
    _close(got.numpy(), want)


@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_paged_decode_wq_any_group(hq, hkv):
    """Padding items and a row with no items (length 0) included: that
    row's output is the V affine of an empty combine, −s_v·z_v."""
    rng = np.random.default_rng(hq + 1)
    q, kp, ks, kz, vp, vs, vz, tbl, lens = _k6_case(
        rng, hq, hkv, 128, 16, [40, 0, 23], 0)
    desc = KVC.build_work_queue(tbl, lens, 16, hkv)
    args = (q, kp, ks, kz, vp, vs, vz, desc)
    want = np.asarray(J_K8(*[jnp.asarray(a) for a in args]))
    targs = [_t(a) for a in args]
    got = OPS.paged_kv4_decode_attention_wq(*targs)
    _close(got.numpy(), want)
    empty = -(vs * vz).reshape(hkv, 128)
    np.testing.assert_allclose(got[1].reshape(hkv, -1, 128).numpy(),
                               np.broadcast_to(empty[:, None],
                                               (hkv, hq // hkv, 128)),
                               rtol=1e-6)
    plan = OPS.work_plan(desc, len(lens) * hkv, 1, hq // hkv, "cpu")
    assert torch.equal(OPS.paged_kv4_decode_attention_wq(*targs, plan=plan),
                       got)


@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_kv4_decode_any_group(hq, hkv):
    args = _k10_case(np.random.default_rng(hq + 2), 3, hq, hkv, 128, 70,
                     [70, 33, 1])
    want = J_K10(*[jnp.asarray(a) for a in args])
    _close(R.kv4_decode_attention_ref(*[_t(a) for a in args]).numpy(), want)


@pytest.mark.parametrize("g,rows,tiles", [(5, 8, 1), (8, 8, 1), (12, 16, 1),
                                          (16, 16, 1), (24, 32, 1),
                                          (40, 32, 2)])
def test_decode_plans_size_rows_to_group(g, rows, tiles):
    """At C = 1 both planners pick the smallest of 8, 16 and 32 rows that
    holds G, and cover larger groups with several row tiles."""
    p = KA.dense_plan(4, 1, g, 2, 8, 64)
    assert p.rows == rows
    assert p.scratch == 0 and p.smem <= KA.DENSE_SMEM_MAX
    desc = np.array([[0, 3, 64, 0], [0, 5, 10, 0], [1, 4, 30, 0],
                     [9, 0, 0, 0]], np.int32)     # row 9: a padding item
    wp = OPS.work_plan(desc, 2, 1, g, "cpu")
    jobs = wp.jobs.numpy()
    assert wp.rows == rows and wp.cg == g
    assert wp.ncompute == 3 * tiles
    assert sorted(jobs[:wp.ncompute, 1].tolist()) == sorted(
        list(range(tiles)) * 3)


# ------------------------------------- the StarCoder2-shaped model, G = 12

@pytest.fixture(scope="module")
def starcoder_model():
    return build_model(SHAPES["starcoder2"])


@pytest.mark.parametrize("config", list(ENGINE_CONFIGS))
def test_engine_matches_reference_g12(starcoder_model, config, xla_trig,
                                     f32_gather):
    """The StarCoder2-shaped 2-layer model (12/1 heads, LayerNorm, GELU,
    QKV bias) in the four engine configurations, held as
    ``test_torch_archs.py`` holds the Qwen2.5-shaped one (G = 5): every
    forward's logits within 2e-2·max|logit| of the JAX engine's, greedy
    agreement ≥ 0.9, the same counters."""
    check_engine_pair(starcoder_model, config)
