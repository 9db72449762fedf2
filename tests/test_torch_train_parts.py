"""The training slice's parts against the JAX reference on the CPU: the
synthetic data stream, AdamW and the cosine schedule, int8
error-feedback compression, checkpoints, GPipe staging; and the port's
own exactness: remat, the chunked loss and ``init_fp``.

Bounds (measured on seeded inputs; the tests print them):

* data and compression bytes: equal;
* AdamW, three updates at lr 1e-2 with and without clipping, against the
  reference's jitted update: params, m and v within 4 f32 ulps of their
  max (measured ≤ 2 ulps: XLA fuses and reorders the jitted arithmetic,
  its f32 ``pow`` is its own, and a clipped update scales by 1/norm, the
  norm an f32 sum in another order; the un-jitted, un-clipped update
  within 0.02 ulps of max: one element, from ``b ** step``); grad norm
  and lr within 2 ulps;
* the schedule with XLA's ``cos`` swapped in: bit for bit;
* ``pipeline_apply``: within the reference test's 2e-5 (f32 matmuls in
  two libraries' orders).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models.lm as LMM
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMData as JData
from repro.parallel import pipeline as JPP
from repro.training import compression as JGC
from repro.training import optimizer as JOPT
from repro_torch.configs.base import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.parallel import pipeline as PP
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import compression as GC
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_loop as TL

F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("seed,step,hosts,host", [
    (0, 0, 1, 0), (11, 9, 1, 0), (3, 1234, 2, 1), (7, 5, 4, 2)])
def test_batches_equal_reference(seed, step, hosts, host):
    kw = dict(vocab_size=1000, seq_len=33, global_batch=8, seed=seed,
              num_hosts=hosts, host_id=host)
    want = JData(JDataConfig(**kw)).batch_for_step(step)
    got = SyntheticLMData(DataConfig(**kw)).batch_for_step(step, "cpu")
    for k in ("tokens", "labels", "mask"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    assert got["tokens"].shape == (8 // hosts, 33)


def test_batch_needs_whole_host_shares():
    data = SyntheticLMData(DataConfig(vocab_size=64, seq_len=4,
                                      global_batch=3, num_hosts=2))
    with pytest.raises(ValueError, match="multiple of num_hosts"):
        data.batch_for_step(0, "cpu")


# ----------------------------------------------------------------- AdamW

def _tree(rng, scale):
    return {"a": rng.normal(size=(64, 32)).astype(np.float32) * scale,
            "b": {"c": rng.normal(size=(128,)).astype(np.float32) * scale,
                  "d": rng.normal(size=(16, 16)).astype(np.float32) * scale}}


def _to_torch(tree):
    return OPT.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _ulps(got, want) -> float:
    got, want = _np(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() * F32_EPS))


@pytest.mark.parametrize("clip", [1.0, 1e6])
@pytest.mark.parametrize("jit", [True, False])
def test_adamw_matches_reference(clip, jit):
    rng = np.random.default_rng(0)
    params = _tree(rng, 1.0)
    grads = [_tree(rng, 0.3) for _ in range(3)]
    jcfg = JOPT.AdamWConfig(lr=1e-2, clip_norm=clip)
    tcfg = OPT.AdamWConfig(lr=1e-2, clip_norm=clip)
    upd = lambda p, g, s: JOPT.adamw_update(jcfg, p, g, s)  # noqa: E731
    upd = jax.jit(upd) if jit else upd
    jp = jax.tree.map(jnp.asarray, params)
    js = JOPT.adamw_init(jp)
    tp = _to_torch(params)
    ts = OPT.adamw_init(tp)
    worst = 0.0
    for g in grads:
        jp, js, jm = upd(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = OPT.adamw_update(tcfg, tp, _to_torch(g), ts)
        for k in ("grad_norm", "lr"):
            assert _ulps(tm[k], jm[k]) <= 2, k
        for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]),
                               (ts["v"], js["v"])):
            for a, b in zip(OPT.tree_leaves(tree_t), jax.tree.leaves(tree_j)):
                worst = max(worst, _ulps(a, b))
        assert int(ts["step"]) == int(js["step"])
    print(f"clip {clip} jit {jit}: worst {worst:.2f} ulps of max")
    assert worst <= 4
    if clip == 1.0:
        assert float(tm["grad_norm"]) > clip          # clipping engaged


def test_schedule_matches_reference(monkeypatch):
    monkeypatch.setattr(torch, "cos", lambda t: torch.from_numpy(
        np.array(jnp.cos(t.numpy()))))
    jfn, tfn = JOPT.cosine_schedule(10, 100), OPT.cosine_schedule(10, 100)
    for step in range(0, 130, 3):
        want = np.asarray(jfn(jnp.asarray(step, jnp.int32)))
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert _np(got).tobytes() == want.tobytes(), step


def test_adamw_minimizes_quadratic():
    cfg = OPT.AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = OPT.adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        g = {"x": 2 * (params["x"] - target)}
        params, state, _ = OPT.adamw_update(cfg, params, g, state)
    np.testing.assert_allclose(params["x"].numpy(), target.numpy(),
                               atol=1e-2)


def test_grad_clipping_bounds_update():
    cfg = OPT.AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    params = {"x": torch.zeros(4)}
    state = OPT.adamw_init(params)
    _, state, m = OPT.adamw_update(cfg, params, {"x": torch.full((4,), 1e6)},
                                   state)
    assert float(m["grad_norm"]) > 1e6              # reported pre-clip
    assert float(state["m"]["x"].abs().max()) <= 0.2


def test_cosine_schedule_shape():
    sched = OPT.cosine_schedule(warmup=10, total=100)
    at = lambda s: float(sched(torch.tensor(s)))    # noqa: E731
    assert at(0) == 0.0 and at(5) == 0.5
    assert abs(at(10) - 1.0) < 0.01 and at(100) <= 0.12


def test_tree_leaves_follow_stacked_reference_order():
    """A list of per-layer dicts is walked as the reference's stacked
    leaves: sorted paths, each over the layers."""
    layer = lambda i: {"w": {"b": i, "a": i + 10}, "n": i + 20}  # noqa
    tree = {"z": 0, "blocks": [layer(1), layer(2)], "e": {"t": 5}}
    assert OPT.tree_leaves(tree) == [21, 22, 11, 12, 1, 2, 5, 0]


# ----------------------------------------------------------- compression

def test_compress_bytes_equal_reference():
    """Payload and scale byte for byte, ties of the rounding included
    (values at exact half steps of the scale)."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(64, 32)).astype(np.float32) * 3
    g.flat[:6] = np.array([127, 0.5, 1.5, -2.5, 62.5, -0.5]) * (
        np.abs(g).max() / 127)
    want_q, want_s = JGC.compress_tensor(jnp.asarray(g))
    q, s = GC.compress_tensor(torch.from_numpy(g))
    assert q.dtype == torch.int8
    assert _np(q).tobytes() == np.asarray(want_q).tobytes()
    assert _np(s).tobytes() == np.asarray(want_s).tobytes()
    d = GC.decompress_tensor(q, s)
    assert _np(d).tobytes() == np.asarray(
        JGC.decompress_tensor(want_q, want_s)).tobytes()
    # half a step, the ties' error, computed in f32
    assert np.abs(_np(d) - g).max() <= float(s) * 0.5 * (1 + 1e-5)


def _pairs(tree) -> list:
    """The (int8, scale) pairs of a compressed tree, keys sorted."""
    if isinstance(tree, tuple):
        return [tree]
    return [p for k in sorted(tree) for p in _pairs(tree[k])]


def test_compress_grads_equal_reference():
    rng = np.random.default_rng(1)
    grads, ef = _tree(rng, 0.01), _tree(rng, 1e-4)
    jq, je = JGC.compress_grads(jax.tree.map(jnp.asarray, grads),
                                jax.tree.map(jnp.asarray, ef))
    tq, te = GC.compress_grads(_to_torch(grads), _to_torch(ef))
    assert len(_pairs(tq)) == len(_pairs(jq)) == 3
    for (q, s), (want_q, want_s) in zip(_pairs(tq), _pairs(jq)):
        assert _np(q).tobytes() == np.asarray(want_q).tobytes()
        assert _np(s).tobytes() == np.asarray(want_s).tobytes()
    for a, b in zip(OPT.tree_leaves(te), jax.tree.leaves(je)):
        assert _np(a).tobytes() == np.asarray(b).tobytes()


def test_error_feedback_accumulates():
    grads = {"w": torch.full((8,), 0.001)}
    ef = GC.init_error_feedback(grads)
    total = torch.zeros(8)
    for _ in range(200):
        comp, ef = GC.compress_grads(grads, ef)
        total = total + GC.decompress_tensor(*comp["w"])
    np.testing.assert_allclose(total.numpy() / 200, 0.001, rtol=0.05)


# ----------------------------------------------------------- checkpoints

def _ckpt_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32)},
            "layers": [torch.ones(3, dtype=torch.bfloat16)]}


def _assert_trees_equal(a, b):
    for x, y in zip(OPT.tree_leaves(a), OPT.tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    tree = _ckpt_tree()
    CKPT.save(str(tmp_path), 7, tree)
    restored, step = CKPT.restore(str(tmp_path), tree, device="cpu")
    assert step == 7
    _assert_trees_equal(tree, restored)
    names = sorted(os.listdir(tmp_path / "step_00000007"))
    assert names == ["_COMPLETE", "arr_00000.npy", "arr_00001.npy",
                     "arr_00002.npy", "manifest.json"]


def test_latest_step_ignores_incomplete(tmp_path):
    CKPT.save(str(tmp_path), 1, _ckpt_tree())
    bad = tmp_path / "step_00000002"       # a crashed save: no _COMPLETE
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert CKPT.latest_step(str(tmp_path)) == 1
    _, step = CKPT.restore(str(tmp_path), _ckpt_tree(), device="cpu")
    assert step == 1


def test_async_save_then_restore(tmp_path):
    tree = _ckpt_tree(3)
    CKPT.save_async(str(tmp_path), 5, tree)
    CKPT.wait_async()
    restored, step = CKPT.restore(str(tmp_path), tree, device="cpu")
    assert step == 5
    _assert_trees_equal(tree, restored)


def test_async_save_error_is_raised_by_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    CKPT.save_async(str(blocker), 1, _ckpt_tree())
    with pytest.raises(OSError):
        CKPT.wait_async()
    CKPT.wait_async()                     # the error is raised once


def test_cleanup_keeps_last(tmp_path):
    for s in (1, 2, 3, 4):
        CKPT.save(str(tmp_path), s, _ckpt_tree())
    CKPT.cleanup(str(tmp_path), keep_last=2)
    assert CKPT.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]


def test_restore_shape_mismatch_raises(tmp_path):
    CKPT.save(str(tmp_path), 1, _ckpt_tree())
    bad = dict(_ckpt_tree(), a=torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="template"):
        CKPT.restore(str(tmp_path), bad, device="cpu")
    renamed = {"x": _ckpt_tree()["a"]}
    with pytest.raises(ValueError, match="leaves"):
        CKPT.restore(str(tmp_path), renamed, device="cpu")


# -------------------------------------------------------------- pipeline

def _stack(l, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(l, d, d)) * 0.2).astype(np.float32)


@pytest.mark.parametrize("l,s,m", [(8, 4, 6), (6, 2, 3), (4, 4, 8)])
def test_pipeline_matches_reference(l, s, m):
    d, mb = 16, 4
    w = _stack(l, d, 0)
    x = np.random.default_rng(1).normal(size=(m, mb, d)).astype(np.float32)
    want = JPP.pipeline_apply(lambda bp, h: jnp.tanh(h @ bp["w"]),
                              JPP.stage_params({"w": jnp.asarray(w)}, s),
                              jnp.asarray(x))
    staged = PP.stage_params([{"w": torch.from_numpy(w[i])}
                              for i in range(l)], s)
    got = PP.pipeline_apply(lambda bp, h: torch.tanh(h @ bp["w"]), staged,
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    seq = torch.from_numpy(x)
    for i in range(l):
        seq = torch.tanh(seq @ torch.from_numpy(w[i]))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_pipeline_grads_flow():
    l, s, m, d, mb = 4, 2, 4, 8, 2
    w = torch.from_numpy(_stack(l, d, 0)).requires_grad_(True)
    x = torch.randn((m, mb, d), generator=torch.Generator().manual_seed(1))
    staged = PP.stage_params([{"w": w[i]} for i in range(l)], s)
    out = PP.pipeline_apply(lambda bp, h: torch.tanh(h @ bp["w"]), staged, x)
    (g,) = torch.autograd.grad(torch.sum(out ** 2), [w])
    assert torch.isfinite(g).all()
    assert all(float(g[i].abs().max()) > 0 for i in range(l))


def test_bubble_fraction_and_staging():
    assert PP.pipeline_bubble_fraction(4, 12) == 3 / 15
    assert PP.pipeline_bubble_fraction(1, 8) == 0.0
    assert PP.stage_params(list(range(6)), 3) == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="equal stages"):
        PP.stage_params(list(range(6)), 4)


# ------------------------------------------------------- port exactness

ARCH = "llama3_8b"


def _model_batch(s=37, seed=0):
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, s))).long()
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, s))).long()
    mask = torch.ones(2, s)
    mask[1, 20:] = 0
    mask[0, :3] = 0
    return cfg, {"tokens": toks, "labels": labels, "mask": mask}


def test_quantized_init_fp_is_init():
    """``quantize(init_fp(s))`` equals ``init(s)`` leaf for leaf."""
    for arch in (ARCH, "zamba2_2p7b", "llama3p2_vision_90b"):
        lm = LMM.LM(get_smoke_config(arch))
        fp = lm.init_fp(3, "cpu")
        assert fp["lm_head"]["w"].dtype == torch.float32
        got, want = lm.quantize(fp), lm.init(3, "cpu")
        assert sorted(got) == sorted(want)
        gl, wl = OPT.tree_leaves(got), OPT.tree_leaves(want)
        assert len(gl) == len(wl)
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(gl, wl)), arch


@pytest.mark.parametrize("chunk", [8, 16, 37, 64])
def test_chunked_loss_equals_plain(chunk):
    """S = 37 (not a multiple of 8 or 16) with a partial mask: the loss
    and the hidden states' gradient equal the full-logits CE's."""
    cfg, batch = _model_batch()
    lm = LMM.LM(cfg)
    params = lm.init_fp(0, "cpu")
    hidden, _ = lm.train_hidden(params, batch["tokens"])
    h1 = hidden.detach().requires_grad_(True)
    h2 = hidden.detach().requires_grad_(True)
    got = TL.chunked_lm_loss(lm, params, h1, batch["labels"], batch["mask"],
                             chunk=chunk)
    want = TL.cross_entropy(lm.head(params, h2), batch["labels"],
                            batch["mask"])
    assert torch.equal(got, want)
    (g1,), (g2,) = torch.autograd.grad(got, [h1]), torch.autograd.grad(
        want, [h2])
    err = float((g1 - g2).abs().max() / g2.abs().max())
    print(f"chunk {chunk}: d hidden error / max {err:.2e}")
    assert err <= 1e-6


def test_remat_grads_equal_plain(monkeypatch):
    """Every layer under ``remat`` (and every loss chunk) gives the
    gradients of the plain forward, bit for bit."""
    cfg, batch = _model_batch()
    lm = LMM.LM(cfg)
    params = lm.init_fp(0, "cpu")
    loss_fn = TL.make_loss_fn(lm, loss_chunk=16)
    (l1, _), g1 = TL.loss_and_grads(loss_fn, params, batch)
    called = []

    def plain(fn, *args):
        called.append(fn)
        return fn(*args)
    monkeypatch.setattr(LMM, "remat", plain)
    monkeypatch.setattr(TL, "remat", plain)
    (l2, _), g2 = TL.loss_and_grads(loss_fn, params, batch)
    assert len(called) == cfg.num_layers + 3      # layers, three chunks
    assert torch.equal(l1, l2)
    for a, b in zip(OPT.tree_leaves(g1), OPT.tree_leaves(g2)):
        assert torch.equal(a, b)
    assert all(not p.requires_grad for p in OPT.tree_leaves(params))


def test_serving_paths_stay_without_autograd():
    cfg, batch = _model_batch(s=8)
    lm = LMM.LM(cfg)
    params = lm.init_fp(0, "cpu")
    for p in OPT.tree_leaves(params):
        p.requires_grad_(True)
    cache = lm.init_cache(2, 16, device="cpu")
    logits, cache = lm.prefill(params, batch["tokens"], cache)
    assert not logits.requires_grad
    logits, _ = lm.decode(params, batch["tokens"][:, :1], cache)
    assert not logits.requires_grad
    logits, _ = lm.train_logits(params, batch["tokens"])
    assert logits.requires_grad
