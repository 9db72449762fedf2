"""The port's serving engine on an MoE model against the JAX reference
engine (CPU, plain kernel versions), and the port's other engine
configurations on the same model.

Test model: 2 layers, d_model 1,024, 8/4 heads × 128 with QK-norm, 8
experts top-2 of width 640 (5 blocks: 4 INT4 + 1 INT8, so every expert
projection runs W4A4 and W4A8), 1 shared expert, vocab 512; weights made
with numpy. The reference runs its unified forward un-jitted, as in
``test_torch_engine.py`` (jitted, XLA reorders the f32 work around the
int4 act-quant and the reference disagrees with itself).

The unified step routes every row of its bucketed token tensor ([1, tb,
d], tb = the step's tokens rounded up to a power of two ≥ 8): padding
rows are routed too, and they change the capacity. Both engines route
the same rows. The prompts prefill in one step, whose 64-row tensor
overflows an expert's 20 slots; decode steps (8 rows, 4 of them padding)
overflow 4-slot experts. What can differ is f32 summation order (the bf16
router's matmul, the GEMMs), so every forward's logits are held to
2e-2·max|logit| and the greedy tokens to an agreement of at least 0.9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models.lm import LM as JLM
from repro.models.lm import QuantConfig as JQuantConfig
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.models.lm import QuantConfig
from repro_torch.serving.engine import Engine, EngineConfig

DIMS = dict(name="torch-moe", family="moe", num_layers=2, d_model=1024,
            num_heads=8, num_kv_heads=4, head_dim=128, d_ff=640,
            vocab_size=512, num_experts=8, num_experts_per_tok=2,
            num_shared_experts=1, moe_d_ff=640, qk_norm=True,
            rope_theta=1_000_000.0)
ENGINE = dict(max_batch=4, num_pages=64, page_size=16, max_pages_per_seq=16,
              prefill_chunk_tokens=64, kv_range=4.0)
PROMPT_LENS, MAX_NEW = (20, 9, 27, 5), 6
# the reference's measured baselines and the mixed W4Ax schedule
BASELINES = {
    "split work_queue": dict(unified_step=False),
    "split dense": dict(unified_step=False, attention_schedule="dense"),
    "whole gather": dict(prefill_mode="whole", decode_attention="gather"),
    "unified dense": dict(attention_schedule="dense"),
    "unified mixed": {},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fp_params(seed=0):
    """Reference-layout fp params (stacked blocks), made with numpy; the
    QK-norm scales off 1, so a dropped norm shows."""
    rng = np.random.default_rng(seed)
    n, d, e, f, v = (DIMS[k] for k in ("num_layers", "d_model",
                                       "num_experts", "moe_d_ff",
                                       "vocab_size"))

    def lin(*shape):
        return {"w": (rng.standard_normal((n, *shape)) / np.sqrt(shape[-2]))
                .astype(np.float32)}

    ones = np.ones((n, d), np.float32)
    blocks = {
        "attn_norm": {"scale": ones}, "mlp_norm": {"scale": ones.copy()},
        "attn": {"wq": lin(d, 1024), "wk": lin(d, 512), "wv": lin(d, 512),
                 "wo": lin(1024, d),
                 "q_norm": {"scale": rng.uniform(0.5, 1.5, (n, 128))
                            .astype(np.float32)},
                 "k_norm": {"scale": rng.uniform(0.5, 1.5, (n, 128))
                            .astype(np.float32)}},
        "moe": {"router": lin(d, e), "w_gate": lin(e, d, f),
                "w_up": lin(e, d, f), "w_down": lin(e, f, d),
                "shared": {"w_up": lin(d, f), "w_gate": lin(d, f),
                           "w_down": lin(f, d)}},
    }
    return {
        "embed": {"table": rng.standard_normal((v, d)).astype(np.float32)},
        "final_norm": {"scale": np.ones(d, np.float32)},
        "lm_head": {"w": (rng.standard_normal((d, v)) / np.sqrt(d))
                    .astype(np.float32)},
        "blocks": blocks,
    }


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JModelConfig(**DIMS), ModelConfig(**DIMS)
    jqc = JQuantConfig(impl="ref")
    fp = jax.tree.map(jnp.asarray, _fp_params())
    qparams, _ = JLM(jcfg, quant=jqc).quantize(
        fp, jax.tree.map(lambda a: None, fp))
    tparams = params_from_jax(jax.tree.map(np.asarray, qparams),
                              device="cpu")
    return jcfg, cfg, jqc, qparams, tparams


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, DIMS["vocab_size"], n).tolist() for n in lens]


def _capture(obj, get, logs):
    inner = obj._guarded_forward

    def wrapped(*a, **k):
        out = inner(*a, **k)
        logs.append(np.array(get(out)))
        return out

    obj._guarded_forward = wrapped


@pytest.fixture(scope="module")
def run(model):
    """Both engines on the pinned requests, every forward's logits logged;
    the port's dropped (token, expert) pairs per MoE call counted."""
    jcfg, cfg, jqc, qparams, tparams = model
    je = JEngine(jcfg, qparams, jqc, JEngineConfig(**ENGINE))
    je._fwd = je._unified_forward           # eager: see the module docstring
    te = Engine(cfg, tparams, QuantConfig(impl="ref"), EngineConfig(**ENGINE),
                device="cpu")
    logs = {"j": [], "t": []}
    _capture(je, lambda o: o[0], logs["j"])
    _capture(te, lambda o: o, logs["t"])
    for i, p in enumerate(_prompts(PROMPT_LENS)):
        je.add_request(i, p, MAX_NEW)
        te.add_request(i, p, MAX_NEW)
    te.moe_dropped = []
    td = te.run()
    return je.run(), td, je, te, logs, [int(d) for d in te.moe_dropped]


def _agreement(jd, td):
    jt = {r.request_id: r.generated for r in jd}
    tt = {r.request_id: r.generated for r in td}
    assert sorted(tt) == sorted(jt) == list(range(len(PROMPT_LENS)))
    total = sum(len(v) for v in jt.values())
    return sum(a == b for i in jt for a, b in zip(jt[i], tt[i])) / total


def test_every_forward_logits_match(run):
    _, _, je, te, logs, _ = run
    assert len(logs["t"]) == len(logs["j"]) == te.steps == je.steps
    for lt, lj in zip(logs["t"], logs["j"]):
        assert lt.shape == lj.shape
        assert np.abs(lt - lj).max() <= 2e-2 * np.abs(lj).max()


def test_greedy_agreement_and_counters(run):
    jd, td, je, te, _, _ = run
    assert _agreement(jd, td) >= 0.9
    for name in ("forward_calls", "attn_forwards", "attn_work_items",
                 "attn_grid_items", "peak_prefill_fp_tokens"):
        assert getattr(te, name) == getattr(je, name), name
    c = te.counters()
    assert c["failed_count"] == c["internal_errors"] == 0
    assert all(len(r.generated) == MAX_NEW for r in td)


def test_capacity_drops_in_the_stream(run):
    """Two MoE calls a forward (one a layer), each over the bucketed
    rows; the prefill step drops pairs past an expert's 20 slots, and
    decode steps drop pairs past 4."""
    _, _, _, te, _, dropped = run
    assert len(dropped) == 2 * te.forward_calls
    assert dropped[0] > 0 or dropped[1] > 0          # the prefill step
    assert sum(d > 0 for d in dropped[2:]) >= 2      # decode steps


@pytest.mark.parametrize("name", list(BASELINES))
def test_port_baselines_run_to_completion(model, name):
    """Every other engine configuration serves the MoE model to the end:
    each request its tokens, no failed step, the pages back."""
    cfg, tparams = model[1], model[4]
    quant = QuantConfig(impl="ref",
                        schedule="mixed" if name == "unified mixed" else
                        "split")
    eng = Engine(cfg, tparams, quant, EngineConfig(**ENGINE,
                                                   **BASELINES[name]),
                 device="cpu")
    free0 = eng.cache.pages_free
    for i, p in enumerate(_prompts(PROMPT_LENS)):
        eng.add_request(i, p, MAX_NEW)
    done = eng.run()
    assert sorted(len(r.generated) for r in done) == [MAX_NEW] * 4
    c = eng.counters()
    assert c["failed_count"] == c["internal_errors"] == 0
    assert eng.cache.pages_free == free0
    assert all(0 <= t < DIMS["vocab_size"] for r in done for t in r.generated)

