"""The mixed W4Ax schedule (K5) of the port against the reference (CPU).

``w4ax_matmul_mixed_ref`` is held to the reference's Pallas kernel
``w4ax_matmul_mixed`` in interpret mode on the reference's own test shapes,
to 1e-5·max|ref|. Both add ``(f32(d)·a_s)·w_s`` block by block into one
accumulator, but XLA on the CPU contracts the accumulate into a fused
multiply-add, so the interpreter rounds once where the port (and its CUDA
kernel, which it matches bit for bit on the card) rounds twice: the
observed error is 0 on the uniform shapes and at most 4.8e-7 (about 1e-7
of max|ref|) on the mixed ones. On the CPU the port's ops take the
reference oracle under either schedule, as the reference's ops do; the
reference's oracle sums with a three-operand XLA einsum, so the two agree
to 1e-5·max|ref| (observed at most 4.8e-7), not bit for bit. The routing
case swaps the C entry points of the kernels for stand-ins that run the
plain versions, so the real wrappers, their degenerate fallbacks and their
launch counters run on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as JQ
from repro.kernels import ops as JOPS
from repro_torch.core import qlinear as QL
from repro_torch.core import quantizer as Q
from repro_torch.kernels import _build
from repro_torch.kernels import act_quant as AQ
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import w4ax_matmul as WK
from repro_torch.models.lm import QuantConfig

# (m, k4, k8, n): the reference's tests/kernels/test_w4ax_matmul.py SHAPES
SHAPES = [(8, 128, 0, 64), (8, 0, 128, 64), (16, 256, 128, 128),
          (64, 384, 128, 256), (130, 128, 256, 192)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(m, k4, k8, n, seed=0):
    """Activations and weights from a numpy seed, quantized by the
    reference's quantizer → numpy (a4, s4, a8, s8, w_packed, w_scale)."""
    rng = np.random.default_rng(seed + m + k4 + k8 + n)
    x = rng.normal(size=(m, k4 + k8)).astype(np.float32)
    w = (rng.normal(size=(k4 + k8, n)) * 0.05).astype(np.float32)
    if k4:
        q4, s4 = JQ.quantize_act_groupwise(jnp.asarray(x[:, :k4]), 128, bits=4)
        a4 = JQ.pack_int4_interleaved(q4, axis=1, block_size=128)
    else:
        a4, s4 = np.zeros((m, 0), np.uint8), np.zeros((m, 0), np.float32)
    if k8:
        a8, s8 = JQ.quantize_act_groupwise(jnp.asarray(x[:, k4:]), 128, bits=8)
    else:
        a8, s8 = np.zeros((m, 0), np.int8), np.zeros((m, 0), np.float32)
    wq = JQ.quantize_weight_int4(jnp.asarray(w), group_size=128)
    return tuple(np.asarray(a) for a in (a4, s4, a8, s8, wq.data, wq.scale))


@pytest.mark.parametrize("m,k4,k8,n", SHAPES)
def test_mixed_ref_matches_reference_kernel(m, k4, k8, n):
    """Against ``w4ax_matmul_mixed`` run by the Pallas interpreter (the
    reference's ops pad M to its tile, as its own tests do)."""
    ops_in = _operands(m, k4, k8, n)
    want = np.asarray(JOPS.w4ax_matmul(*ops_in, schedule="mixed",
                                       impl="pallas"))
    got = WK.w4ax_matmul_mixed_ref(*map(_t, ops_in)).numpy()
    assert got.shape == want.shape == (m, n)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("schedule", ["split", "mixed"])
@pytest.mark.parametrize("m,k4,k8,n", SHAPES)
def test_ops_on_cpu_take_the_reference_oracle(m, k4, k8, n, schedule):
    """Off the kernel path a CPU tensor takes the split oracle under
    either schedule (bit for bit the port's ``w4ax_matmul_ref``), within
    1e-5·max|ref| of the reference's ops; leading dims are flattened and
    restored."""
    ops_in = _operands(m, k4, k8, n, seed=1)
    want = np.asarray(JOPS.w4ax_matmul(*ops_in, schedule=schedule,
                                       impl="ref"))
    a4, s4, a8, s8, w, ws = map(_t, ops_in)
    got = OPS.w4ax_matmul(a4, s4, a8, s8, w, ws, schedule=schedule,
                          impl="ref")
    nb4 = k4 // 128
    oracle = WK.w4ax_matmul_ref(a4, s4, a8, s8, w[:k4 // 2], ws[:nb4],
                                w[k4 // 2:], ws[nb4:])
    assert torch.equal(got, oracle)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
    if m % 2 == 0:
        lead = [t.reshape(2, m // 2, -1) for t in (a4, s4, a8, s8)]
        got3 = OPS.w4ax_matmul(*lead, w, ws, schedule=schedule)
        assert torch.equal(got3.reshape(m, n), got)


def test_mixed_rounding_order_differs_from_split():
    """One accumulator with ``(d·a_s)·w_s`` against two summed
    accumulators with ``d·(a_s·w_s)``: the same function, apart in the
    last bits only."""
    a4, s4, a8, s8, w, ws = map(_t, _operands(64, 384, 128, 256, seed=2))
    mixed = WK.w4ax_matmul_mixed_ref(a4, s4, a8, s8, w, ws)
    split = WK.w4ax_matmul_ref(a4, s4, a8, s8, w[:192], ws[:3], w[192:],
                               ws[3:])
    diff = (mixed - split).abs().max()
    assert 0 < diff <= 1e-5 * split.abs().max()


@pytest.mark.parametrize("k4,k8", [(0, 256), (384, 0)])
def test_degenerate_mixed_is_the_uniform_plain_version(k4, k8):
    a4, s4, a8, s8, w, ws = map(_t, _operands(16, k4, k8, 128, seed=3))
    got = WK.w4ax_matmul_mixed_ref(a4, s4, a8, s8, w, ws)
    want = (WK.w4a8_matmul_ref(a8, s8, w, ws) if k4 == 0
            else WK.w4a4_matmul_ref(a4, s4, w, ws))
    assert torch.equal(got, want)


def test_schedule_and_impl_are_validated():
    a4, s4, a8, s8, w, ws = map(_t, _operands(8, 128, 128, 64))
    with pytest.raises(ValueError, match="schedule must be split|mixed"):
        OPS.w4ax_matmul(a4, s4, a8, s8, w, ws, schedule="fused")
    with pytest.raises(ValueError, match="schedule must be split|mixed"):
        QuantConfig(schedule="fused")
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        OPS.w4ax_matmul(a4, s4, a8, s8, w, ws, schedule="mixed",
                        impl="cuda")
    with pytest.raises(ValueError, match="empty GEMM"):
        WK.w4ax_matmul_mixed_ref(a4[:, :0], s4, a8[:, :0], s8, w, ws)


# ------------------------------------------------------------- routing

PLAIN = {
    "act_quant_w4ax": lambda x, tag, stride, m, k, k4, *out: [
        t.copy_(r) for t, r in zip(out, AQ.act_quant_w4ax_ref(x, k4))],
    "w4a4_matmul": lambda a, s, w, ws, out, *_: out.copy_(
        WK.w4a4_matmul_ref(a, s, w, ws)),
    "w4a8_matmul": lambda a, s, w, ws, out, *_: out.copy_(
        WK.w4a8_matmul_ref(a, s, w, ws)),
    "w4ax_matmul_mixed": lambda a4, s4, a8, s8, w, ws, out, *_: out.copy_(
        WK.w4ax_matmul_mixed_ref(a4, s4, a8, s8, w, ws)),
}


@pytest.fixture
def stand_ins(monkeypatch):
    """Every C entry point runs its plain version on the CPU; the wrappers
    (checks but the device one, fallbacks, launch counts) are the real
    ones. → the kernel launch counts, reset."""
    monkeypatch.setattr(_build, "call",
                        lambda lib, fn, dev, *args: PLAIN[fn](*args))
    monkeypatch.setattr(OPS, "use_kernel", lambda impl, t: True)
    monkeypatch.setattr(WK, "_check_gemm", lambda a, a_s, w, w_s, nb, cols:
                        (a.shape[0], w.shape[1]))
    monkeypatch.setattr(AQ, "_check", lambda x: None)
    for kern in OPS.KERNELS.values():
        monkeypatch.setattr(kern, "launches", 0)
    return OPS.KERNELS


@pytest.mark.parametrize("k,schedule,fraction,want", [
    (1024, "mixed", 0.875, {"act_quant_w4ax": 1, "w4ax_matmul_mixed": 1}),
    (1024, "split", 0.875, {"act_quant_w4ax": 1, "w4a4_matmul": 1,
                            "w4a8_matmul": 1}),
    (128, "mixed", 0.875, {"act_quant_w4ax": 1, "w4a4_matmul": 1}),
    (256, "mixed", 0.0, {"act_quant_w4ax": 1, "w4a8_matmul": 1}),
])
def test_qlinear_routes_to_the_schedule_kernels(stand_ins, k, schedule,
                                                fraction, want):
    """K = 1024 at 0.875 is 7 + 1 blocks: the mixed schedule launches K5
    once and neither uniform kernel; the split schedule K3 and K4. A
    uniform projection (K = 128 at 0.875, or fraction 0) falls back to the
    one uniform kernel under ``mixed``, as the reference does. Either
    way the activation's two channel ranges are one act-quant launch."""
    rng = np.random.default_rng(k)
    n = 64
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) / 30)
    wp, ws = Q.quantize_weight_int4(w)
    x = torch.from_numpy(rng.normal(size=(3, 5, k)).astype(np.float32))
    quant = QuantConfig(int4_fraction=fraction, schedule=schedule,
                        impl="cuda")
    out = QL.dispatch_qlinear({"w_packed": wp, "w_scale": ws}, x, quant)
    got = {name: kern.launches for name, kern in stand_ins.items()
           if kern.launches}
    assert got == want
    # the routed result is the schedule's plain function of the same
    # quantized operands
    plain = QL.dispatch_qlinear({"w_packed": wp, "w_scale": ws}, x,
                                QuantConfig(int4_fraction=fraction,
                                            schedule=schedule, impl="ref"))
    assert out.shape == (3, 5, n)
    tol = 1e-5 * float(plain.abs().max())
    assert float((out - plain).abs().max()) <= tol
