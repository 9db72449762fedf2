"""Training over a ``(data, model)`` mesh on the CPU: gloo ranks spawned
by ``launch.mesh.spawn`` (one thread each), held to

* ``parallel.mesh.serial_train`` (the same mesh as threads of one
  process, every rank-order sum of seams, gradients and norms the same)
  bit for bit: each step's metrics and every rank's params, AdamW moments
  and carried compression error — the llama3_8b smoke config at 1 × 2,
  2 × 1 and 2 × 2, 3 steps plain and compressed; the Moonlight smoke
  config at 1 × 2 (its 8 experts over the model axis);
* the plain one-device step on the same params and batches within the
  bounds ``tests/test_torch_train_step.py`` states for one device (the
  seams and the data split sum in other orders): loss ≤ 1e-3 and grad
  norm ≤ 1e-2 relative a step; the params moved by AdamW's ~lr·sign(g)
  at most 2·lr a step apart (max ≤ 6·lr after 3 steps, mean ≤
  0.05·lr); the moments leaf by leaf as that file bounds them after
  its two steps. The Moonlight model after one step, as that file holds
  the MoE's gradients: from the second step on a router logit summed in
  another order sends a token to another expert (1 of 96 in layer 0, 10
  in layer 1 at step 2, measured), as the reference's jit does against
  its own eager run;
* the 2 × 2 run, once, to the reference's jitted one-device
  ``make_train_step`` within the same bounds.

Checkpoints restore across meshes bit for bit; the TRAIN_RULES specs of
a dimension its axis does not divide are the reference's, and such a
mesh (1 × 4: two kv heads over four ranks, split mid-head; 1 × 3:
nothing divides) trains within the bounds. The ranks import no JAX and
no ``repro`` module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import _torch_family_ref as FR
import _torch_train_ranks as R
from repro.configs.base import get_smoke_config as j_smoke
from repro.models.lm import LM as JLM
from repro.parallel import sharding as JSH
from repro.training import optimizer as JOPT
from repro.training import train_loop as JTL
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import spawn
from repro_torch.models.lm import LM
from repro_torch.parallel.mesh import Mesh, serial_train
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optimizer as OPT

ARCH, MOE = "llama3_8b", "moonshot_v1_16b_a3b"
STEPS = 3
MESHES = ((2, 2), (1, 2), (2, 1))       # spawned in this order
RUNS = [(ARCH, d, m, c, STEPS) for d, m in MESHES for c in (False, True)
        ] + [(MOE, 1, 2, False, STEPS), (MOE, 1, 2, False, 1)]
IDS = [f"{'moe' if a == MOE else 'dense'}-{d}x{m}-"
       f"{'compressed' if c else 'plain'}-{n}" for a, d, m, c, n in RUNS]
BOUNDED = [r for r in RUNS if r[0] == ARCH or r[4] == 1]
LOSS_TOL, GNORM_TOL = 1e-3, 1e-2
P_MAX, P_MEAN = 2 * STEPS, 0.05          # × lr
MATRIX_TOL, CHANNEL_TOL = 2e-2, 0.15     # of a moment leaf's max


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawned mesh's jobs, their serial_train twins and the plain
    one-device runs, once: the 2 × 2 ranks also save their state and
    restore a one-device checkpoint, the 1 × 2 ranks restore the 2 × 2
    one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("train_mesh")
    one_dir, mesh_dir = str(root / "one"), str(root / "mesh")
    try:
        plain = {(a, c, n): R.run_steps(None, a, n, c)
                 for a, c, n in {(a, c, n) for a, _, _, c, n in RUNS}}
        CKPT.save(one_dir, STEPS, plain[(ARCH, False, STEPS)]["state"][:2])
        jobs = {m: [("steps", a, n, c, None) for a, d, mm, c, n in RUNS
                    if (d, mm) == m] for m in MESHES}
        jobs[(2, 2)][0] = ("steps", ARCH, STEPS, False, mesh_dir)
        jobs[(2, 2)].append(("restore", ARCH, one_dir))
        jobs[(1, 2)].append(("restore", ARCH, mesh_dir))
        spawned = {m: spawn(R.rank_jobs, m[0] * m[1], (*m, jobs[m]),
                            threads=1, timeout_s=240.0)
                   for m in MESHES}
        serial = {run: serial_train(R.run_steps, run[1], run[2], "cpu",
                                    (run[0], run[4], run[3]))
                  for run in RUNS}
        odd = {m: serial_train(R.run_steps, *m, "cpu", (ARCH, STEPS, False))
               for m in ((1, 4), (1, 3))}
    finally:
        torch.set_num_threads(n)
    return {"plain": plain, "spawned": spawned, "serial": serial,
            "jobs": jobs, "odd": odd, "one_dir": one_dir,
            "mesh_dir": mesh_dir}


def _mesh_run(runs, run) -> list:
    """Every rank's result of ``run`` (arch, data, model, compressed,
    steps)."""
    arch, d, m, c, n = run
    i = next(i for i, j in enumerate(runs["jobs"][(d, m)])
             if j[0] == "steps" and (j[1], j[2], j[3]) == (arch, n, c))
    return [ranks[i] for ranks in runs["spawned"][(d, m)]]


def _bits(x: np.ndarray) -> bytes:
    return x.dtype.str.encode() + x.tobytes()


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_mesh_equals_serial_train(runs, run):
    """Every rank's metrics, params, moments (and carried error) equal
    serial_train's, byte for byte; the ranks agree on every metric."""
    got = _mesh_run(runs, run)
    want = runs["serial"][run]
    assert len(got) == len(want) == run[1] * run[2]
    for r, (g, w) in enumerate(zip(got, want)):
        assert g["metrics"] == w["metrics"] == got[0]["metrics"], r
        host = R.host(w["state"])
        assert [p for p, _ in g["state"]] == [p for p, _ in host]
        bad = [p for (p, a), (_, b) in zip(g["state"], host)
               if _bits(a) != _bits(b)]
        assert not bad, (r, bad[:5])


def _f32(bits) -> np.ndarray:
    return np.array(bits, np.int32).view(np.float32)


def check_bounds(got_state: dict, got_metrics, want_state: dict,
                 want_metrics, label: str):
    """Metrics a step, params after the steps (max and mean in units of
    lr) and the moments leaf by leaf within the module's bounds."""
    gm, wm = _f32(got_metrics), _f32(want_metrics)
    for k, tol in ((0, LOSS_TOL), (1, LOSS_TOL), (3, GNORM_TOL)):
        rel = np.abs(gm[:, k] - wm[:, k]) / np.abs(wm[:, k])
        assert (rel <= tol).all(), (label, R.METRICS[k], rel)
    assert np.isfinite(gm).all()
    np.testing.assert_allclose(gm[:, 4], wm[:, 4], rtol=1e-6)
    assert sorted(got_state) == sorted(want_state), label
    dmax = dsum = 0.0
    count = 0
    worst = {}
    for path, w in want_state.items():
        g = got_state[path].float()
        w = w.float()
        d = (g - w).abs()
        kind = path.split("/")[1] if path[0] == "1" else "p"
        if path.startswith("0/"):
            dmax = max(dmax, float(d.max()))
            dsum += float(d.sum())
            count += d.numel()
        elif kind in ("m", "v"):
            scale = float(w.abs().max())
            tol = (CHANNEL_TOL if w.dim() == 1 else MATRIX_TOL) * (
                2 if kind == "v" else 1)
            rel = float(d.max()) / scale if scale else float(d.max())
            worst[kind] = max(worst.get(kind, 0.0), rel / tol)
            assert rel <= tol, (label, path, rel, tol)
    print(f"{label}: params max {dmax / R.LR:.3f}·lr, mean "
          f"{dsum / count / R.LR:.4f}·lr; moments' worst share of their "
          f"bound {worst}")
    assert dmax <= P_MAX * R.LR and dsum / count <= P_MEAN * R.LR, label


def _plain_state(runs, arch, c, n=STEPS) -> dict:
    return dict(CKPT.flatten(runs["plain"][(arch, c, n)]["state"]))


def _whole(results, arch, d, m) -> dict:
    """The spawned ranks' host states → {key path: whole tensor}."""
    return R.whole([[torch.from_numpy(a) for _, a in r["state"]]
                    for r in results], arch, d, m, [p for p, _ in
                                                    results[0]["state"]])


@pytest.mark.parametrize("run", BOUNDED,
                         ids=[i for i, r in zip(IDS, RUNS) if r in BOUNDED])
def test_mesh_within_bounds_of_one_device(runs, run):
    arch, d, m, c, n = run
    got = _mesh_run(runs, run)
    check_bounds(_whole(got, arch, d, m), got[0]["metrics"],
                 _plain_state(runs, arch, c, n),
                 runs["plain"][(arch, c, n)]["metrics"],
                 "-".join(map(str, run)))


@pytest.mark.parametrize("mesh", [(1, 4), (1, 3)], ids=["1x4", "1x3"])
def test_indivisible_mesh_within_bounds(runs, mesh):
    """Two kv heads over four model ranks (each rank's q head uses half
    of a gathered kv head) and a model axis of 3 that divides nothing:
    still the one-device step within the bounds."""
    res = runs["odd"][mesh]
    assert all(r["metrics"] == res[0]["metrics"] for r in res)
    check_bounds(_whole([{"state": R.host(r["state"])} for r in res], ARCH,
                        *mesh),
                 res[0]["metrics"], _plain_state(runs, ARCH, False),
                 runs["plain"][(ARCH, False, STEPS)]["metrics"], f"{mesh}")


def test_2x2_within_bounds_of_reference(runs):
    """The 2 × 2 run against the reference's jitted one-device
    ``make_train_step`` from the same fp params on the same batches."""
    cfg = get_smoke_config(ARCH)
    fp_np = FR._stacked(FR.port_fp_params(cfg))
    jcfg = JOPT.AdamWConfig(lr=R.LR, schedule=JOPT.cosine_schedule(1, 4))
    jstep = jax.jit(JTL.make_train_step(JLM(j_smoke(ARCH)), jcfg,
                                        loss_chunk=R.CHUNK))
    jp = jax.tree.map(jnp.asarray, fp_np)
    js = JOPT.adamw_init(jp)
    metrics = []
    for b in R.batches(cfg, STEPS):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v.numpy())
                                    for k, v in b.items()})
        metrics.append(np.array([float(jm[k]) if k in jm else 0.0
                                 for k in R.METRICS], np.float32)
                       .view(np.int32).tolist())
    want = {"0": params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            "1": {"m": params_from_jax(jax.tree.map(np.asarray, js["m"]),
                                       "cpu"),
                  "v": params_from_jax(jax.tree.map(np.asarray, js["v"]),
                                       "cpu"),
                  "step": torch.tensor(int(js["step"]), dtype=torch.int32)}}
    got = _mesh_run(runs, (ARCH, 2, 2, False, STEPS))
    check_bounds(_whole(got, ARCH, 2, 2), got[0]["metrics"],
                 dict(CKPT.flatten((want["0"], want["1"]))), metrics,
                 "2x2 vs reference")


def test_restores_across_meshes(runs):
    """The directory the 2 × 2 mesh wrote holds its whole leaves; restored
    onto 1 × 2 and onto one device (1 × 1) every leaf is them bit for
    bit; a one-device directory restored onto 2 × 2 is the one-device
    state bit for bit."""
    mesh_run = _mesh_run(runs, (ARCH, 2, 2, False, STEPS))
    params = LM(get_smoke_config(ARCH)).init_fp(seed=1, device="cpu")
    saved, step = CKPT.restore(runs["mesh_dir"],
                               (params, OPT.adamw_init(params)),
                               device="cpu")
    assert step == STEPS
    whole = _whole(mesh_run, ARCH, 2, 2)
    flat = CKPT.flatten(saved)
    assert [p for p, _ in flat] == list(whole)
    for p, t in flat:
        assert _bits(t.numpy()) == _bits(whole[p].numpy()), p
    on_1x2 = runs["spawned"][(1, 2)]
    for ranks in on_1x2:
        got = ranks[len(runs["jobs"][(1, 2)]) - 1]
        assert [p for p, _ in got] == [p for p, _ in flat]
        for (p, a), (_, t) in zip(got, flat):
            assert _bits(a) == _bits(t.numpy()), p
    one = CKPT.flatten(runs["plain"][(ARCH, False, STEPS)]["state"][:2])
    for ranks in runs["spawned"][(2, 2)]:
        got = ranks[len(runs["jobs"][(2, 2)]) - 1]
        assert [p for p, _ in got] == [p for p, _ in one]
        for (p, a), (_, t) in zip(got, one):
            assert _bits(a) == _bits(t.numpy()), p


def test_restore_shardings_shape_mismatch_raises(runs, tmp_path):
    """A spec tree whose shards do not have the template's shapes raises
    (here the 2 × 2 specs onto a 1 × 2 template), and so does a spec of
    the wrong rank."""
    lm = LM(get_smoke_config(ARCH))
    m12, m22 = (Mesh(shape={"data": d, "model": 2}) for d in (1, 2))
    params = lm.init_fp(seed=1, device="cpu", mesh=m12)
    template = (params, OPT.adamw_init(params))
    specs = lm.train_specs(m22)
    with pytest.raises(ValueError, match="sharded"):
        CKPT.restore(runs["one_dir"], template, device="cpu",
                     shardings=(specs, OPT.state_specs(specs)), mesh=m22)
    bad = lm.train_specs(m12)
    bad["final_norm"]["scale"] = (None, None)
    with pytest.raises(ValueError, match="spec"):
        CKPT.restore(runs["one_dir"], template, device="cpu",
                     shardings=(bad, OPT.state_specs(bad)), mesh=m12)


def _jmesh(data: int, model: int):
    n = data * model
    return JMesh(np.array((jax.devices() * n)[:n]).reshape(data, model),
                 ("data", "model"))


@pytest.mark.parametrize("arch", [ARCH, MOE])
@pytest.mark.parametrize("mesh", [(2, 3), (3, 4), (4, 8)],
                         ids=["2x3", "3x4", "4x8"])
def test_train_rules_specs_match_reference(arch, mesh):
    """``LM.train_specs`` equals the reference's ``tree_pspecs(axes,
    params, mesh, TRAIN_RULES)`` leaf by leaf on meshes where dimensions
    do not divide (they stay replicated): kv heads split mid-head, a
    model axis of 3, a data axis of 3 over d_model 128 (not divisible),
    8 experts over 8 ranks."""
    params, axes = JLM(j_smoke(arch)).init(jax.random.PRNGKey(0))
    want = JSH.tree_pspecs(axes, params, _jmesh(*mesh), JSH.TRAIN_RULES)
    got = LM(get_smoke_config(arch)).train_specs(
        Mesh(shape={"data": mesh[0], "model": mesh[1]}))
    want_flat = dict(FR._flat(jax.tree.map(
        tuple, want, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                  PartitionSpec))))
    checked = 0
    for path, spec in FR._flat(got):
        if path[0] == "blocks":       # the reference stacks the layers
            key = ("blocks",) + path[2:]
            ref = want_flat[key][1:]
        else:
            ref = want_flat[path]
        assert spec == tuple(ref), (path, spec, ref)
        checked += 1
    assert checked > 10
    if mesh == (2, 3):
        attn = got["blocks"][0]["attn"]
        assert attn["wq"]["w"] == ("data", None)   # 128 % 3 ≠ 0
        assert got["embed"]["table"] == (None, "data")


def test_ranks_import_no_reference(runs):
    for ranks in runs["spawned"].values():
        for r in ranks:
            assert r[-1] == []


@pytest.mark.parametrize("cards, want", [(4, (2, 2)), (3, (3, 1)),
                                         (2, (2, 1)), (1, (1, 1))])
def test_fit_mesh_shrinks_as_the_reference(monkeypatch, cards, want):
    """The trainer's launcher asks for the reference's shrink before it
    starts the ranks: ``data = min(data, n)``, ``model = min(model, n //
    data)`` with a warning naming the mesh; it never shrinks on the CPU,
    or when the cards suffice, or when not asked."""
    from repro_torch.launch import mesh as LMESH
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    ask = (want[0] if cards == 4 else 4, 2 if cards == 4 else 4)
    if cards == 4:
        assert LMESH.fit_mesh(*ask, "cuda", allow_shrink=True) == ask
    else:
        with pytest.warns(UserWarning, match=f"data={want[0]}, "
                                              f"model={want[1]}"):
            assert LMESH.fit_mesh(*ask, "cuda", allow_shrink=True) == want
    assert LMESH.fit_mesh(*ask, "cuda") == ask
    assert LMESH.fit_mesh(8, 8, "cpu", allow_shrink=True) == (8, 8)
    with pytest.raises(ValueError, match=">= 1"):
        LMESH.fit_mesh(0, 2, "cuda", allow_shrink=True)
