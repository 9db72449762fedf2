"""Port quantizer and act-quant vs the JAX reference: byte-exact codes,
packing and scales, including exact .5 ties and all-zero blocks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as JQ
from repro.kernels import ops as JOPS
from repro_torch.core import quantizer as Q
from repro_torch.kernels import ops as OPS


def _ties(rng, m, k, qmax):
    """Random activations plus a block whose scale is exactly 1 (absmax ==
    qmax) holding every odd multiple of 0.5 — rounding ties — and an
    all-zero block."""
    x = (rng.normal(size=(m, k)) * 3).astype(np.float32)
    x[0, :128] = ((np.arange(128) % 15) - 7) * 0.5
    x[0, 0] = qmax
    x[-1, -128:] = 0.0
    return x


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k", [(1, 128), (5, 384), (16, 1024)])
def test_act_quant_groupwise_byte_exact(bits, m, k):
    x = _ties(np.random.default_rng(m * k + bits), m, k, 7 if bits == 4 else 127)
    qj, sj = JQ.quantize_act_groupwise(jnp.asarray(x), bits=bits)
    qt, st = Q.quantize_act_groupwise(torch.from_numpy(x), bits=bits)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (qt[-1, -128:] == 0).all()       # all-zero block → zero codes


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_act_quant_op_matches_reference(bits, impl):
    """ops.act_quant (payload + scales) from a bf16 input, against the
    reference's oracle and its Pallas kernel in interpret mode. The
    interpret-mode kernel is not IEEE on exact .5 ties (XLA compiles its
    ``x / scale`` differently: 2 of 384 tie codes moved), so — like the
    reference's own Pallas test — it sees random inputs only; the tie
    block is held against the oracle, whose division the port follows."""
    rng = np.random.default_rng(bits)
    x = _ties(rng, 3, 256, 7 if bits == 4 else 127)
    if impl == "pallas":
        x = (rng.normal(size=x.shape) * 3).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16).reshape(1, 3, 256)
    pj, sj = JOPS.act_quant(xb, bits=bits, impl=impl)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    pt, st = OPS.act_quant(xt, bits=bits, impl="auto")
    assert pt.shape == tuple(pj.shape) and st.shape == tuple(sj.shape)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_ties_round_half_to_even():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 7.0] + [0.0] * 121])
    q, s = Q.quantize_act_groupwise(x, bits=4)
    assert float(s[0, 0]) == 1.0
    assert q[0, :7].tolist() == [0, 2, 2, 0, -2, -2, 7]


@pytest.mark.parametrize("shape,bs", [((256, 8), 128), ((128, 3), None),
                                      ((6, 512), 128)])
def test_pack_unpack_interleaved(shape, bs):
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, size=shape).astype(np.int8)
    dim = 0 if shape[0] % 128 == 0 else 1
    pj = JQ.pack_int4_interleaved(jnp.asarray(q), axis=dim, block_size=bs)
    pt = Q.pack_int4_interleaved(torch.from_numpy(q), dim=dim, block_size=bs)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    back = Q.unpack_int4_interleaved(pt, dim=dim, block_size=bs)
    np.testing.assert_array_equal(back.numpy(), q)


@pytest.mark.parametrize("k,n", [(256, 64), (1024, 96)])
def test_quantize_weight_int4_byte_exact(k, n):
    rng = np.random.default_rng(k + n)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    w[:128, 0] = 0.0                                   # an all-zero group
    qt_j = JQ.quantize_weight_int4(jnp.asarray(w), group_size=128)
    packed, scale = Q.quantize_weight_int4(torch.from_numpy(w), 128)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(qt_j.data))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(qt_j.scale))
    deq = Q.dequantize_weight_int4(packed, scale)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(JQ.dequantize_weight_int4(qt_j, 128)))


def test_absmax_scale_matches():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 2, 128)).astype(np.float32)
    x[1, 1] = 0.0
    for bits in (4, 8):
        np.testing.assert_array_equal(
            Q.absmax_scale(torch.from_numpy(x), dim=2, bits=bits).numpy(),
            np.asarray(JQ.absmax_scale(jnp.asarray(x), axis=2, bits=bits)))
