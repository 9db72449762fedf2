"""The port's training step against the JAX reference on the CPU: each
family's loss and every leaf's gradient on one model (the port's fp
init of the smoke config carried into the reference), the whole train
step with and without int8 error-feedback compression, and convergence.

The reference runs jitted (``jax.jit(jax.value_and_grad(make_loss_fn(
lm)))``, as its launcher does), but the MoE family un-jitted: jitted,
its router's bf16 logits land in another order and route some tokens to
other experts (the reference's jit/eager gap, ROADMAP caveats), which
moves its expert gradients by up to 0.78 of their max against its own
un-jitted run. XLA's cos/sin run in the port's RoPE, one PyTorch thread
(``tests/_torch_family_ref.py``).

Bounds, with the values measured at writing (printed by the tests):

* loss and MoE aux: relative error ≤ 1e-3 (measured ≤ 2.0e-4);
* a projection, embedding or head leaf (≥ 2 dims): max|Δg| ≤
  2e-2·max|g| (measured ≤ 1.8e-2: bf16 products summed in XLA's and
  PyTorch's orders);
* a per-channel leaf (norm scales and biases, Mamba2's ``A_log``, ``D``,
  ``dt_bias``, ``conv_w``/``conv_b``, RWKV-6's mixing and decay vectors):
  ≤ 0.15·max|g| (measured ≤ 0.099, Zamba2's ``A_log``): each element
  is a sum over every position of bf16-rounded terms that mostly cancel;
* the VLM's 0-d cross gate: ≤ 0.5·|g| (measured 0.33: its terms'
  Σ|·| is ~60× the sum, so bf16's 2⁻⁸ per term is ~0.3 of the result);
* every family: ‖Δg‖₂ ≤ 2e-2·‖g‖₂ over the whole tree.
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_family_ref as FR
from repro.configs.base import get_smoke_config as j_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMData as JData
from repro.models.lm import LM as JLM
from repro.training import compression as JGC
from repro.training import optimizer as JOPT
from repro.training import train_loop as JTL
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.models.lm import LM
from repro_torch.training import compression as GC
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_loop as TL

FAMILIES = {"dense": "llama3_8b", "moe": "moonshot_v1_16b_a3b",
            "hybrid": "zamba2_2p7b", "ssm": "rwkv6_1p6b",
            "vlm": "llama3p2_vision_90b", "audio": "hubert_xlarge"}
EAGER = ("moe",)
B, S, CHUNK = 2, 24, 16          # two loss chunks, the second padded
LOSS_TOL, MATRIX_TOL, CHANNEL_TOL, GATE_TOL, L2_TOL = (1e-3, 2e-2, 0.15,
                                                        0.5, 2e-2)


@pytest.fixture(autouse=True, scope="module")
def pinned():
    with FR.pinned_torch():
        yield


def _batch(cfg):
    """Seeded tokens and labels from the synthetic stream, a partial
    mask, and the family's frames or image embeddings; (reference,
    port)."""
    toks, labels = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)).host_batch(0)
    mask = np.ones((B, S), np.float32)
    mask[1, S - 5:] = 0
    jx, tx = FR.extra_inputs(cfg, B, S)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "mask": jnp.asarray(mask), **(jx or {})}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long(),
          "mask": torch.from_numpy(mask), **(tx or {})}
    return jb, tb


@functools.lru_cache(maxsize=None)
def family_run(family: str):
    """Both packages' loss, parts and gradients on one model of the
    family; once a process."""
    arch = FAMILIES[family]
    cfg = get_smoke_config(arch)
    fp_np = FR._stacked(FR.port_fp_params(cfg))
    jb, tb = _batch(cfg)
    vg = jax.value_and_grad(JTL.make_loss_fn(JLM(j_smoke(arch)),
                                             loss_chunk=CHUNK), has_aux=True)
    t0 = time.perf_counter()
    if family in EAGER:
        with jax.disable_jit():
            (jl, jparts), jg = vg(jax.tree.map(jnp.asarray, fp_np), jb)
    else:
        (jl, jparts), jg = jax.jit(vg)(jax.tree.map(jnp.asarray, fp_np), jb)
    ref = {"loss": float(jl), "aux": float(jparts["aux"]),
           "grads": params_from_jax(jax.tree.map(np.asarray, jg), "cpu")}
    t1 = time.perf_counter()
    params = params_from_jax(fp_np, device="cpu")
    (loss, parts), grads = TL.loss_and_grads(
        TL.make_loss_fn(LM(cfg), loss_chunk=CHUNK), params, tb)
    port = {"loss": float(loss), "aux": float(parts["aux"]), "grads": grads}
    print(f"{arch}: reference {t1 - t0:.1f} s, port "
          f"{time.perf_counter() - t1:.1f} s")
    return cfg, ref, port


def _leaf_tol(path, t) -> float:
    if t.dim() == 0:
        return GATE_TOL
    if t.dim() == 1 or path[-1] == "conv_w":
        return CHANNEL_TOL
    return MATRIX_TOL


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference(family):
    cfg, ref, port = family_run(family)
    err = abs(port["loss"] - ref["loss"]) / abs(ref["loss"])
    print(f"{family}: loss {port['loss']:.6f} vs {ref['loss']:.6f} "
          f"({err:.2e}), aux {port['aux']:.6e} vs {ref['aux']:.6e}")
    assert np.isfinite(port["loss"]) and err <= LOSS_TOL
    if family == "moe":
        assert ref["aux"] > 0
        assert abs(port["aux"] - ref["aux"]) <= LOSS_TOL * ref["aux"]
    else:
        assert port["aux"] == ref["aux"] == 0
    want = dict(FR._flat(ref["grads"]))
    got = dict(FR._flat(port["grads"]))
    assert sorted(got, key=str) == sorted(want, key=str)
    worst = {}
    num = den = 0.0
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == torch.float32, path
        assert torch.isfinite(g).all(), path
        d = float((g - w).abs().max())
        scale = float(w.abs().max())
        num += float(((g - w).double() ** 2).sum())
        den += float((w.double() ** 2).sum())
        tol = _leaf_tol(path, w)
        rel = d / scale if scale else d
        worst[tol] = max(worst.get(tol, (0.0, None)), (rel, path))
        if scale == 0:        # the VLM's cross blocks under a zero gate
            assert d == 0, path
        else:
            assert rel <= tol, (path, rel, tol)
    l2 = (num / den) ** 0.5
    print(f"{family}: worst per class {worst}; ‖Δg‖/‖g‖ {l2:.2e}")
    assert l2 <= L2_TOL


# ------------------------------------------------------ whole train step

def _dense_pair(seed_batch=0):
    arch = FAMILIES["dense"]
    cfg = get_smoke_config(arch)
    fp_np = FR._stacked(FR.port_fp_params(cfg))
    data = JData(JDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                             global_batch=4))
    jb = data.batch_for_step(seed_batch)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in jb.items()}
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    return arch, cfg, fp_np, jb, tb


STEP_LR = 1e-3


@pytest.mark.parametrize("compressed", [False, True])
def test_train_step_matches_reference(compressed):
    """Two steps of ``make_train_step`` (or the compressed step) from the
    same params, state and batches. AdamW's first steps move each weight
    by ~lr·sign(g), so a weight whose tiny gradient has the other sign
    (bf16 summation order) lands 2·lr away: bound max|Δp| ≤ 4·lr (two
    steps) and mean|Δp| ≤ 0.05·lr (measured 3.14·lr and 0.008·lr); m as
    the gradients (2e-2 of its max on the matrices, 0.15 on per-channel
    leaves), v twice that (squares); the metrics' loss within 1e-3, grad
    norm within 1e-2."""
    arch, cfg, fp_np, jb0, tb0 = _dense_pair(0)
    _, _, _, jb1, tb1 = _dense_pair(1)
    jlm, lm = JLM(j_smoke(arch)), LM(cfg)
    jcfg = JOPT.AdamWConfig(lr=STEP_LR, schedule=JOPT.cosine_schedule(1, 4))
    tcfg = OPT.AdamWConfig(lr=STEP_LR, schedule=OPT.cosine_schedule(1, 4))
    jp = jax.tree.map(jnp.asarray, fp_np)
    js = JOPT.adamw_init(jp)
    tp = params_from_jax(fp_np, device="cpu")
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    if compressed:
        jstep = jax.jit(JGC.make_compressed_train_step(jlm, jcfg,
                                                       loss_chunk=CHUNK))
        tstep = GC.make_compressed_train_step(lm, tcfg, loss_chunk=CHUNK)
        jef, tef = JGC.init_error_feedback(jp), GC.init_error_feedback(tp)
    else:
        jstep = jax.jit(JTL.make_train_step(jlm, jcfg, loss_chunk=CHUNK))
        tstep = TL.make_train_step(lm, tcfg, loss_chunk=CHUNK)
    for jb, tb in ((jb0, tb0), (jb1, tb1)):
        if compressed:
            jp, js, jef, jm = jstep(jp, js, jef, jb)
            tp, ts, tef, tm = tstep(tp, ts, tef, tb)
        else:
            jp, js, jm = jstep(jp, js, jb)
            tp, ts, tm = tstep(tp, ts, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-3 * float(
            jm["loss"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= (
            1e-2 * float(jm["grad_norm"]))
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    got = opt_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    want_p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert int(ts["step"]) == int(got["step"]) == 2
    dmax = dmean = 0.0
    flat_w = dict(FR._flat(want_p))
    n = 0
    for path, a in FR._flat(tp):
        d = (a - flat_w[path]).abs()
        dmax = max(dmax, float(d.max()))
        dmean += float(d.sum())
        n += d.numel()
    dmean /= n
    print(f"compressed={compressed}: max|Δp| {dmax / STEP_LR:.3f}·lr, "
          f"mean {dmean / STEP_LR:.4f}·lr")
    assert dmax <= 4 * STEP_LR and dmean <= 0.05 * STEP_LR
    for key in ("m", "v"):
        want = dict(FR._flat(got[key]))
        for path, a in FR._flat(ts[key]):
            w = want[path]
            scale = float(w.abs().max())
            rel = float((a - w).abs().max()) / scale
            # v sums squares: twice the gradients' relative error
            assert rel <= _leaf_tol(path, w) * (2 if key == "v" else 1), (
                key, path, rel)
    if compressed:
        want = dict(FR._flat(params_from_jax(jax.tree.map(np.asarray, jef),
                                             "cpu")))
        for path, a in FR._flat(tef):
            # each carried error is under half a quantization step, which
            # the gradients' bf16 noise moves element by element: hold
            # each leaf's largest to the reference's within a factor 2
            ra, rw = float(a.abs().max()), float(want[path].abs().max())
            assert rw / 2 <= ra <= 2 * rw, (path, ra, rw)


# ------------------------------------------------------------ convergence

@pytest.mark.parametrize("compressed", [False, True])
def test_loss_decreases(compressed):
    """The reference's convergence case: the smoke model learns the
    synthetic stream, loss down by more than 0.5 in 30 steps at lr
    2e-3 (weight decay 0)."""
    cfg = get_smoke_config("llama3_8b")
    lm = LM(cfg)
    params = lm.init_fp(0, "cpu")
    state = OPT.adamw_init(params)
    opt = OPT.AdamWConfig(lr=2e-3, weight_decay=0.0)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=8, seed=0))
    if compressed:
        step = GC.make_compressed_train_step(lm, opt)
        ef = GC.init_error_feedback(params)
    else:
        step = TL.make_train_step(lm, opt)
    losses = []
    for i in range(30):
        batch = data.batch_for_step(i, "cpu")
        if compressed:
            params, state, ef, m = step(params, state, ef, batch)
        else:
            params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    print(f"compressed={compressed}: losses {losses[::6]} → {losses[-1]}")
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, losses[::6]
