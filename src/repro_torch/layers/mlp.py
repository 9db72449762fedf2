"""Feed-forward layers (``repro/layers/mlp.py``): the dense MLP (SwiGLU,
or the non-gated tanh-GELU of StarCoder2) and the capacity-dropped top-k
MoE with shared experts (``moe_apply``).

The MoE keeps the reference's f32 arithmetic where it decides or weighs
anything. On the CPU it is XLA's, bit for bit: XLA's CPU ``exp`` (a
Cephes polynomial with fused multiply-adds, :func:`exp_xla`), its flush
of f32 subnormals to zero, its row sums (sequential over windows of 32,
then over the windows) and its scatter order. The card runs the same
formulas with PyTorch's ``exp``, ``silu`` and ``sigmoid`` (XLA's CPU
forms are for the CPU, where the port is held to the reference), and
sums the softmax's row in f64 (as ``common.row_mean`` does): a row's
routing then does not depend on its batch's layout.
"""

from __future__ import annotations

import struct

import torch

from repro_torch.layers import common as C
from repro_torch.parallel import sharding as SH

__all__ = ["mlp_apply", "silu_bf16", "gelu_bf16", "gelu_f32", "exp_xla",
           "silu_f32", "sigmoid_f32", "softplus_f32", "softmax_f32",
           "moe_route", "moe_capacity", "moe_dispatch", "moe_apply"]

_BF16_TINY = torch.finfo(torch.bfloat16).tiny
# the constants of jax.nn.gelu(approximate=True), rounded to bf16 as JAX
# rounds them for a bf16 input (np.sqrt(2/π).astype(dtype); the weakly
# typed 0.044715 takes the array's dtype)
_GELU_C = float(torch.tensor(0.7978845608028654, dtype=torch.bfloat16))
_GELU_K = float(torch.tensor(0.044715, dtype=torch.bfloat16))


def silu_bf16(x: torch.Tensor) -> torch.Tensor:
    """SiLU as the reference's XLA computes it in bf16: x · 1/(1+e^{−x})
    with a bf16 rounding after every op. A fused silu rounds once and
    differs in the last bit often enough to flip the int4 codes of the
    down projection's act-quant."""
    return x * (1 / (torch.exp(-x) + 1))


class _Flush(torch.autograd.Function):
    """y with |y| < ``tiny`` (the subnormals, and zero) replaced by y·0,
    a signed zero: XLA's CPU flush. Its gradient is the identity's: the
    flush is the compiler's, not part of the function JAX differentiates
    (a ``torch.where`` would give those points a zero gradient, e.g.
    ``exp_xla``'s at an argument of exactly 0)."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, tiny: float) -> torch.Tensor:
        return torch.where(y.abs() < tiny, y * 0, y)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def _round(y: torch.Tensor) -> torch.Tensor:
    """An f32 result → bf16 as XLA's CPU rounds one bf16 op: subnormal
    results flushed to (signed) zero first, then one rounding."""
    return _Flush.apply(y, _BF16_TINY).to(torch.bfloat16)


def gelu_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (tanh form) on bf16 as the reference computes:
    x·(0.5·(1 + tanh(c·(x + k·x³)))) with x³ = x·(x·x) (``integer_pow``),
    c and k rounded to bf16, every op in f32 and rounded to bf16 after it,
    subnormal operands and results flushed to zero. Bit for bit on every
    finite bf16 input; ``F.gelu(approximate="tanh")`` differs on ~1,500 of
    them, and a differing bit moves the down projection's act-quant
    codes."""
    def r(y):
        return _round(y).float()

    x = r(x.float())
    x3 = r(x * r(x * x))
    inner = r(_GELU_C * r(x + r(_GELU_K * x3)))
    cdf = r(0.5 * r(1.0 + r(torch.tanh(inner))))
    return _round(x * cdf)


_GELU_C32 = struct.unpack("f", struct.pack("f", 0.7978845608028654))[0]


def gelu_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (tanh form) on f32: x·(0.5·(1 + tanh(c·(x +
    0.044715·x·(x·x))))) op by op in f32, c = √(2/π) rounded to f32.
    PyTorch's ``tanh``: XLA's CPU one differs in the last bit of f32,
    which the callers' cast to bf16 hides but for near-ties."""
    inner = _GELU_C32 * (x + 0.044715 * (x * (x * x)))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def mlp_apply(params, x: torch.Tensor, quant=None,
              act: str = "swiglu", mesh=None, spec=None) -> torch.Tensor:
    """SwiGLU (up and gate share one act-quant of x) or, under ``act=
    "gelu"``, GELU of the up projection; then the down projection. With
    a training ``mesh`` whose model axis shards ``w_down``'s K
    (``spec``): up/gate on this rank's channels of ``fanout(x)``, the
    down projection the row-parallel seam (``common.row_linear``)."""
    tp = (mesh is not None and mesh.size > 1
          and spec["w_down"]["w"][0] == "model")
    if tp:
        x = SH.fanout(x, mesh, "model")
    if act == "swiglu":
        up, gate = C.linears([params["w_up"], params["w_gate"]], x, quant)
        h = silu_bf16(gate) * up
    elif act == "gelu":
        h = gelu_bf16(C.linear(params["w_up"], x, quant))
    else:
        raise ValueError(act)
    if tp:
        return C.row_linear(params["w_down"], h, mesh)
    return C.linear(params["w_down"], h, quant)


# ---------------------------------------------------------------- MoE

_F32_TINY = torch.finfo(torch.float32).tiny


def _f32(c: float) -> float:
    """A constant rounded to f32, as XLA's emitter holds it."""
    return struct.unpack("f", struct.pack("f", c))[0]


_LOG2E = _f32(1.44269504088896341)
_LN2_HI, _LN2_LO = _f32(0.693359375), _f32(-2.12194440e-4)
_EXP_POLY = tuple(_f32(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                                    8.3334519073e-3, 4.1665795894e-2,
                                    1.6666665459e-1, 5.0000001201e-1))
_EXP_LO, _EXP_HI = _f32(-87.8), _f32(88.8)


def _ftz(y: torch.Tensor) -> torch.Tensor:
    """XLA's CPU flushes f32 subnormals (operands and results) to zero
    (:class:`_Flush`)."""
    return _Flush.apply(y, _F32_TINY)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a·b + c`` with one multiply-add: the f64 product of two f32
    values is exact, and the f64 sum rounded to f32 is the fused result
    unless it lies exactly halfway between two f32 values (never among
    the 420,012 arguments ``tests/test_torch_moe.py`` compares with
    XLA's)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def exp_xla(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of an f32 tensor as XLA's CPU computes it: x clamped to
    [-87.8, 88.8], n = ⌊x·log2(e) + ½⌋ in [-127, 127], a = x − n·ln 2 in two
    parts, e^a by Cephes' degree-5 polynomial, times 2^n (0 at n = −127),
    subnormals flushed. Bit for bit with ``jnp.exp`` on the CPU (PyTorch's
    own ``exp`` differs in the last bit on 8.5 % of the arguments the
    tests draw). On the card, where no reference runs, PyTorch's ``exp``:
    one op, not the ~50 of the polynomial."""
    if x.is_cuda:
        return torch.exp(x)
    x = _ftz(x).clamp(_EXP_LO, _EXP_HI)
    n = torch.floor(_fma(x, _LOG2E, 0.5)).clamp(-127, 127)
    a = _fma(-n, _LN2_LO, _fma(-n, _LN2_HI, x))
    z = _fma(a, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        z = _fma(z, a, c)
    z = 1 + _fma(z, a * a, a)
    ni = n.to(torch.int32)
    pow2 = torch.where(ni > -127, ((ni + 127) << 23).view(torch.float32),
                       torch.zeros_like(z))
    return _ftz(z * pow2)


def silu_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` on f32 as XLA's CPU computes it: x · (1 / (e^{−x} +
    1)), its ``exp`` (:func:`exp_xla`), subnormals flushed; on the card
    PyTorch's ``silu``."""
    if x.is_cuda:
        return torch.nn.functional.silu(x)
    x = _ftz(x)
    return _ftz(x * _ftz(torch.reciprocal(exp_xla(-x) + 1)))


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis, kept. On the CPU XLA's order for a row of
    f32: from 0 over each window of 32 in turn, then the windows' sums
    from 0. On the card an f64 sum rounded once (batch-invariant rows)."""
    if x.is_cuda:
        return x.double().sum(-1, keepdim=True).float()
    total = x.new_zeros(x.shape[:-1])
    for lo in range(0, x.shape[-1], 32):
        part = x.new_zeros(x.shape[:-1])
        for i in range(lo, min(lo + 32, x.shape[-1])):
            part = part + x[..., i]
        total = total + part
    return total[..., None]


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` on f32 as XLA's CPU computes it: 1 / (e^{−x} +
    1) with its ``exp``, subnormals flushed (bit for bit); on the card
    PyTorch's ``sigmoid``."""
    if x.is_cuda:
        return torch.sigmoid(x)
    return _ftz(torch.reciprocal(exp_xla(-_ftz(x)) + 1))


def softplus_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` on f32: ``jnp.logaddexp(x, 0)`` = max(x, 0) +
    log1p(e^{−|x|}), with XLA's ``exp``. ``F.softplus`` computes
    log1p(eˣ) below a threshold of 20 and differs in the last bits; the
    ``log1p`` here is PyTorch's (XLA's differs from it in the last bit on
    ~14 % of arguments)."""
    return torch.clamp_min(x, 0) + torch.log1p(exp_xla(-x.abs()))


def softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis of f32 logits: e^{x − max}
    (:func:`exp_xla`) over its row sum (:func:`_row_sum`)."""
    ex = exp_xla(logits - logits.amax(-1, keepdim=True))
    return ex / _row_sum(ex)


def moe_route(params, tkn: torch.Tensor, cfg, quant=None, logits=None):
    """The router of ``moe_apply``: tokens [T, d] → (probs [T, E] f32,
    gate_vals [T, k] renormalized, gate_idx [T, k]). The bf16 router's
    logits (or ``logits``, made by the caller) in f32, softmax, the top k
    by a stable descending sort (so among equal probabilities the lower
    expert comes first, as ``jax.lax.top_k``; ``torch.topk`` promises no
    order for ties), each row's k values divided by their sum taken from
    0 in order."""
    k = cfg.num_experts_per_tok
    if logits is None:
        logits = C.linear(params["router"], tkn, quant)
    probs = softmax_f32(logits.float())
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    total = torch.zeros_like(vals[:, 0])
    for j in range(k):
        total = total + vals[:, j]
    return probs, vals / total.clamp_min(1e-9)[:, None], idx


def moe_capacity(cfg, t: int) -> int:
    """Slots per expert for a batch of ``t`` token rows."""
    return max(int(cfg.capacity_factor * t * cfg.num_experts_per_tok
                   / cfg.num_experts), 4)


def moe_dispatch(gate_idx: torch.Tensor, num_experts: int, cap: int):
    """Sort-based dispatch of ``gate_idx`` [T, k] → (order [T·k]: the
    (token, choice) pairs sorted stably by expert, keep [T·k]: whether the
    sorted pair has a slot, slot [T·k]: its row of the ``[E·cap]``
    buffers, ``E·cap`` when dropped). The first ``cap`` pairs of each
    expert in token order keep their slot."""
    t, k = gate_idx.shape
    flat_e = gate_idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=gate_idx.device) - starts[sorted_e]
    keep = pos < cap
    return order, keep, torch.where(keep, sorted_e * cap + pos,
                                    num_experts * cap)


def moe_apply(params, x: torch.Tensor, cfg, quant=None, dropped=None,
              mesh=None, spec=None):
    """x: [B, S, d] → (out [B, S, d] in x's dtype, the Switch aux loss):
    top-k routing with capacity ``max(int(capacity_factor·T·k/E), 4)``
    per expert, T = B·S (every row routed, padding included), as
    ``repro/layers/mlp.py`` ``moe_apply``.

    Dispatch: the (token, choice) pairs sorted stably by expert; the
    first ``cap`` of each expert fill its capacity buffer ``[E, cap, d]``
    in that order, the rest are dropped (their slot is a scratch row past
    the buffers). Empty slots stay zero rows. The experts' SwiGLU runs on
    the stacks (gate and up share one act-quant of the buffers; the
    activation ``silu(gate)·up`` in f32, :func:`silu_f32`, rounded once to
    bf16 — not the dense MLP's op-by-op bf16 SiLU); the down projection
    gives ``[E, cap, d]``. Combine: each token adds its kept outputs ×
    gate weights from 0 in ascending expert order (the reference's
    ``segment_sum`` order) — a fixed sequence of gathers, no atomics —
    then the shared experts' output (``mlp_apply``) in f32. ``dropped``:
    a list the call appends its count of dropped (token, expert) pairs
    to, as a 0-d tensor (no host sync).

    With a training ``mesh`` whose model axis shards the expert stacks
    (``spec``; experts over "model"), routing, capacity and dispatch run
    alike on every model rank (the activations are replicated over the
    axis); the router's logits are its column-parallel E/M slices
    gathered; each rank runs its E/M experts on its rows of the buffer
    and adds its own experts' terms (others' weigh nothing), and the
    ranks' f32 partial sums meet in the seam (``SH.reduce_sum``). The
    gate weights and the tokens go in through ``fanout``: their
    gradients are summed over the ranks."""
    b, s, d = x.shape
    tkn = x.reshape(b * s, d)
    t, e, k = tkn.shape[0], cfg.num_experts, cfg.num_experts_per_tok
    dev = tkn.device
    ep = mesh is not None and mesh.size > 1
    if ep and spec["w_gate"]["w"][0] != "model":
        raise NotImplementedError(
            f"{e} experts do not split over a model axis of {mesh.size}: "
            f"only expert parallelism is ported for training over a mesh")
    if ep:
        tkn_fan = SH.fanout(tkn, mesh, "model")
        logits = C.linear(params["router"], tkn_fan, quant)
        if spec["router"]["w"][-1] == "model":
            logits = SH.gather_cols(logits, mesh, "slice")
        probs, gate_vals, gate_idx = moe_route(params, tkn, cfg, quant,
                                               logits)
    else:
        tkn_fan = tkn
        probs, gate_vals, gate_idx = moe_route(params, tkn, cfg, quant)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(gate_idx, e).sum(1).float().mean(0)
    aux = (me * ce).sum() * e * cfg.router_aux_loss

    cap = moe_capacity(cfg, t)
    order, keep, slot = moe_dispatch(gate_idx, e, cap)
    if dropped is not None:
        dropped.append((~keep).sum())

    buf = tkn_fan.new_zeros((e * cap + 1, d))
    buf[slot] = tkn_fan[order // k]               # drops land on row e·cap
    xe = buf[:e * cap].reshape(e, cap, d).to(torch.bfloat16)
    e0, n_e = 0, e
    if ep:
        n_e = e // mesh.size
        e0 = mesh.model_rank * n_e
        xe = xe[e0:e0 + n_e]
        gate_vals = SH.fanout(gate_vals, mesh, "model")

    gate, up = C.linears([params["w_gate"], params["w_up"]], xe, quant)
    h = _ftz(silu_f32(gate.float()) * _ftz(up.float())).to(torch.bfloat16)
    ye = C.linear(params["w_down"], h, quant).reshape(n_e * cap, d)

    mine = slot - e0 * cap
    held = keep & (mine >= 0) & (mine < n_e * cap)
    gathered = torch.where(held[:, None],
                           ye[mine.clamp(0, n_e * cap - 1)], 0.0)
    weighted = _ftz(_ftz(gathered.float())
                    * gate_vals.reshape(-1)[order][:, None])
    # each token's entries in the sorted list, in ascending expert order
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=dev)
    rank = rank.reshape(t, k).sort(-1).values
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for j in range(k):
        out = _ftz(out + weighted[rank[:, j]])
    if ep:
        out = SH.reduce_sum(out, mesh, "model")
    if "shared" in params:
        out = _ftz(out + mlp_apply(params["shared"], tkn, quant,
                                   mesh=mesh if ep else None,
                                   spec=spec.get("shared") if ep
                                   else None).float())
    return out.reshape(b, s, d).to(x.dtype), aux
