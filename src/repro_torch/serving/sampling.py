"""Host sampling of the serving engine: the batched per-request sampler
and the speculative verifier's rejection sampler (the reference keeps
both in ``repro/serving/engine.py``: ``_make_sample_fn``,
``_sample_batch``, ``_spec_probs``, ``_reject_sample``).

**The batched sampler** reproduces the reference's jitted JAX sampler in
numpy, step by step (JAX's threefry PRNG with
``jax_threefry_partitionable``, the default of the JAX the reference
runs on):

- key: ``fold_in(fold_in(PRNGKey(0), rid), pos)`` with
  ``fold_in(k, d) = threefry2x32(k, (0, d))`` and ``PRNGKey(0) = (0, 0)``;
- bits of a row of ``kmax`` candidates: ``y0 ^ y1`` of
  ``threefry2x32(key, (0, i))`` for ``i < kmax`` (the 64-bit iota's
  high and low words);
- uniform: ``max(tiny, (f32(bits >> 9 | 0x3F800000) - 1)·(1 - tiny) +
  tiny)`` in f32;
- token: ``argmax(-log(-log(u)) + topv / t)`` over the top-``kmax``
  logits of the row (``jax.lax.top_k``'s order: descending in the total
  order of f32, so +0 before -0, ties lowest index first), those past
  the row's own ``top_k`` masked to -inf, ``kmax`` the power-of-two
  bucket of the batch's largest ``top_k`` (at most V); rows with
  ``t <= 0`` take the argmax of the whole row.

Bit for bit: the keys, the bits, the uniforms, the top-k values and
their order, and ``topv / t``. Not bit for bit: the Gumbel noise, since
XLA's f32 ``log`` on the CPU and numpy's differ in the last bits on about
a third of uniforms. A token can only differ where two candidates'
noisy scores lie within those bits of each other; the tests hold the
tokens equal on thousands of rows.

**The rejection sampler** (``spec_probs``, ``reject_sample``) is the
reference's f64 numpy code, copied unchanged: it is already host code,
seeded by ``np.random.default_rng((rid & 0x7FFFFFFF, pos, 0x5BEC))``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["threefry2x32", "fold_in", "sample_keys", "random_bits",
           "uniform", "top_k", "sample_batch", "spec_probs",
           "reject_sample"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = np.finfo(np.float32).tiny


def _u32(a) -> np.ndarray:
    """Integers → uint32, two's complement (``jnp.uint32`` of an int32)."""
    return (np.asarray(a, np.int64) & 0xFFFFFFFF).astype(np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (``jax._src.prng``): keys and counters
    are uint32 arrays that broadcast together → the two output words."""
    k0, k1, x0, x1 = np.broadcast_arrays(*(_u32(a) for a in (k0, k1, x0,
                                                             x1)))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [x0 + ks[0], x1 + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def fold_in(keys: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in`` of ``[..., 2]`` uint32 keys with integers
    ``data`` (one per key) → ``[..., 2]``."""
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0, _u32(data))
    return np.stack([y0, y1], axis=-1)


def sample_keys(rids, positions) -> np.ndarray:
    """The sampler's key of each row, ``fold_in(fold_in(PRNGKey(0), rid),
    pos)`` → ``[n, 2]`` uint32."""
    rids = np.atleast_1d(np.asarray(rids))
    base = np.zeros((len(rids), 2), np.uint32)
    return fold_in(fold_in(base, rids), np.atleast_1d(np.asarray(positions)))


def random_bits(keys: np.ndarray, k: int) -> np.ndarray:
    """``jax.random.bits(key, (k,))`` for each key of ``[n, 2]`` → ``[n, k]``
    uint32."""
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], 0,
                          np.arange(k, dtype=np.uint32)[None, :])
    return y0 ^ y1


def uniform(keys: np.ndarray, k: int) -> np.ndarray:
    """``jax.random.uniform(key, (k,), minval=tiny, maxval=1)`` for each
    key → ``[n, k]`` f32 (the uniforms of ``jax.random.gumbel``)."""
    bits = (random_bits(keys, k) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    scale = np.float32(1.0) - np.float32(_TINY)
    return np.maximum(np.float32(_TINY),
                      floats * scale + np.float32(_TINY))


def _order_key(x: np.ndarray) -> np.ndarray:
    """f32 → int32 keys in the total order of f32 (-0 below +0)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return bits ^ ((bits >> 31) & np.int32(0x7FFFFFFF))


def top_k(logits: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """``jax.lax.top_k`` over the last axis of ``[n, V]`` f32 → (values,
    indices) ``[n, k]``: descending in f32's total order, ties lowest
    index first (``np.argpartition`` alone picks ties at the boundary in
    no set order)."""
    n, v = logits.shape
    # every candidate at or above the k-th largest value (±0 compare
    # equal here, so this holds the top k in the total order too), then
    # sorted by (row, total-order value descending, index)
    kth = np.partition(logits, v - k, axis=1)[:, v - k:v - k + 1]
    r, c = np.nonzero(logits >= kth)
    key = _order_key(logits[r, c]).astype(np.int64)
    order = np.lexsort((c, -key, r))
    r, c = r[order], c[order]
    idx = c[np.searchsorted(r, np.arange(n))[:, None] + np.arange(k)]
    return np.take_along_axis(logits, idx, 1), idx


def sample_batch(logits: np.ndarray, rids, positions, temps,
                 topks) -> np.ndarray:
    """One token per row of ``logits`` ``[n, V]`` (f32), each row with its
    own request id, position, temperature and ``top_k`` → ``[n]`` int64.
    Rows with temperature ≤ 0 take their argmax."""
    logits = np.ascontiguousarray(logits, np.float32)
    n, v = logits.shape
    temps = np.asarray(temps, np.float32)
    topks = np.minimum(np.asarray(topks, np.int64), v)
    greedy = np.argmax(logits, axis=-1)
    hot = np.nonzero(temps > 0)[0]
    if not len(hot):
        return greedy
    kmax = min(max(1, 1 << (int(topks.max()) - 1).bit_length()), v)
    topv, topi = top_k(logits[hot], kmax)
    masked = np.where(np.arange(kmax)[None, :] < topks[hot, None],
                      topv / temps[hot, None], np.float32(-np.inf))
    u = uniform(sample_keys(np.asarray(rids)[hot],
                            np.asarray(positions)[hot]), kmax)
    gumbel = -np.log(-np.log(u))
    pick = np.argmax(gumbel + masked, axis=-1)
    out = greedy.copy()
    out[hot] = topi[np.arange(len(hot)), pick]
    return out


def spec_probs(row: np.ndarray, temp: float, top_k: int) -> np.ndarray:
    """Top-k/temperature sampling distribution for one logits row
    (float64 host softmax — the speculative verifier's reference
    measure)."""
    lg = np.asarray(row, np.float64) / max(temp, 1e-8)
    if top_k < lg.shape[0]:
        kth = np.partition(lg, -top_k)[-top_k]
        lg = np.where(lg >= kth, lg, -np.inf)
    lg = lg - lg.max()
    p = np.exp(lg)
    return p / p.sum()


def reject_sample(row: np.ndarray, temp: float, top_k: int,
                  drafted: Optional[int], rid: int, pos: int):
    """Exact rejection sampling against a DETERMINISTIC draft proposal.

    The prompt-lookup draft is a point mass q = δ(drafted), so the
    textbook accept probability min(1, p/q) collapses to p(drafted) and
    the residual distribution to p restricted to x ≠ drafted,
    renormalized — together they reproduce p exactly, which is the
    speculative-sampling guarantee. ``drafted=None`` (the bonus
    position after full acceptance) is a plain draw from p. Seeded by
    (request_id, position) like the batched sampler, so reruns replay.
    Returns (token, accepted)."""
    p = spec_probs(row, temp, top_k)
    rng = np.random.default_rng((int(rid) & 0x7FFFFFFF, int(pos), 0x5BEC))
    if drafted is not None:
        if rng.random() < p[drafted]:
            return int(drafted), True
        residual = p.copy()
        residual[drafted] = 0.0
        mass = residual.sum()
        if mass <= 0.0:
            # p WAS the point mass at the draft — the residual is empty
            # and the only exact outcome is the drafted token
            return int(drafted), True
        p = residual / mass
    return int(rng.choice(p.shape[0], p=p)), False
