"""The training step (``repro/training/train_loop.py``): the chunked
cross-entropy loss, the loss of a batch, and ``train_step``.

The vocabulary-chunked loss never holds the full [B, S, V] logits: the
head, logsumexp and gold gather run per sequence chunk under
:func:`models.lm.remat`, so the live logits are [B, chunk, V] in the
forward and again in the backward — at Llama-3-8B's 128,256-token vocab,
2.1 GB a 512-token chunk of 8 rows against 33.6 GB for 1,024 tokens
whole. Autograd takes the place of ``jax.value_and_grad``; the products
are the model's bf16 ``torch.matmul``s, as the reference computes them
outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from repro_torch.models.lm import LM, remat
from repro_torch.training import optimizer as OPT

__all__ = ["cross_entropy", "chunked_lm_loss", "make_loss_fn",
           "make_train_step", "loss_and_grads"]


def _token_ce(logits, labels):
    """logsumexp(logits) − the gold label's logit, per position."""
    return (torch.logsumexp(logits, -1)
            - torch.gather(logits, -1, labels[..., None])[..., 0])


def cross_entropy(logits, labels, mask=None):
    """logits [..., V] f32, labels [...] int → mean CE (masked: Σ ce·mask
    / max(Σ mask, 1))."""
    ce = _token_ce(logits, labels)
    if mask is not None:
        return torch.sum(ce * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(ce)


def _chunk_ce(lm: LM, params, h, labels, mask):
    return (torch.sum(_token_ce(lm.head(params, h), labels) * mask),
            torch.sum(mask))


def chunked_lm_loss(lm: LM, params, hidden, labels, mask=None,
                    chunk: int = 512):
    """hidden [B, S, D] (after the final norm) → scalar CE without the
    full logits: S padded to a multiple of ``chunk`` (hidden and labels
    with zeros, the mask with zeros), each chunk's head + logsumexp +
    gold gather under :func:`remat`, the chunks' sums and mask counts
    added in order from 0, then Σ / max(count, 1)."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    pad = -s % chunk
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        t, c = remat(_chunk_ce, lm, params, hidden[:, sl], labels[:, sl],
                     mask[:, sl])
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp_min(cnt, 1.0)


def make_loss_fn(lm: LM, *, loss_chunk: int = 512):
    """``loss_fn(params, batch) → (ce + aux, {"ce", "aux"})``; ``extra``
    from the batch's ``frames`` (audio) or ``image_embeds`` (vlm)."""
    def loss_fn(params, batch):
        extra = {k: batch[k] for k in ("frames", "image_embeds")
                 if k in batch} or None
        hidden, aux = lm.train_hidden(params, batch["tokens"], extra)
        ce = chunked_lm_loss(lm, params, hidden, batch["labels"],
                             batch.get("mask"), chunk=loss_chunk)
        return ce + aux, {"ce": ce, "aux": aux}
    return loss_fn


def loss_and_grads(loss_fn, params, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: → ((loss, parts),
    grads), grads a tree of ``params``' shape (f32 like the params; a
    leaf the loss does not reach gets zeros). The leaves are made to
    require grad for the call and released after it."""
    leaves = OPT.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, parts = loss_fn(params, batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, gs)}
    grads = OPT.tree_map(lambda p: by_id[id(p)], params)
    return ((loss.detach(), {k: v.detach() for k, v in parts.items()}),
            grads)


def make_train_step(lm: LM, opt_cfg: OPT.AdamWConfig, *,
                    loss_chunk: int = 512):
    """``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``; params and state are updated in place (the reference's
    launcher donates them) and returned. ``batch``: ``{"tokens": [B, S]
    int, "labels": [B, S] int, optional "mask": [B, S] f32, optional
    "frames"/"image_embeds"}``. ``metrics``: ``loss``, ``ce``, ``aux``,
    ``grad_norm`` and ``lr``, 0-d tensors on the params' device (not
    read back to the host)."""
    loss_fn = make_loss_fn(lm, loss_chunk=loss_chunk)

    def train_step(params, opt_state, batch):
        (loss, parts), grads = loss_and_grads(loss_fn, params, batch)
        params, opt_state, om = OPT.adamw_update(opt_cfg, params, grads,
                                                 opt_state)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step
