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

Over a ``(data, model)`` mesh (``mesh=``, ``specs=`` from
``LM.train_specs``; params, gradients and AdamW state are this rank's
shards) each data rank takes its rows of the global batch
(``sharding.batch_rows``); the mask count is summed over the data ranks
before the forward, a rank's loss is its chunks' Σ over that count, and
its backward sums the data ranks' gradients in rank order where each
param is gathered. The reported loss is ((tot₀ + tot₁) + …) / count: the
reference's Σ / count up to the order of the sum.
"""

from __future__ import annotations

import torch

from repro_torch.models.lm import LM, remat
from repro_torch.parallel import mesh as PM
from repro_torch.parallel import sharding as SH
from repro_torch.training import optimizer as OPT

__all__ = ["cross_entropy", "chunked_lm_sums", "chunked_lm_loss",
           "make_loss_fn", "make_train_step", "loss_and_grads"]


def _token_ce(logits, labels):
    """logsumexp(logits) − the gold label's logit, per position (labels
    of any integer type: the data stream's int64, the reference's int32
    in the dry run)."""
    return (torch.logsumexp(logits, -1)
            - torch.gather(logits, -1, labels[..., None].long())[..., 0])


def cross_entropy(logits, labels, mask=None):
    """logits [..., V] f32, labels [...] int → mean CE (masked: Σ ce·mask
    / max(Σ mask, 1))."""
    ce = _token_ce(logits, labels)
    if mask is not None:
        return torch.sum(ce * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(ce)


def _chunk_ce(lm: LM, params, h, labels, mask, mesh=None, specs=None):
    logits = (lm.head(params, h) if mesh is None
              else lm.mesh_head(params, specs, h, mesh))
    return torch.sum(_token_ce(logits, labels) * mask), torch.sum(mask)


def _padded(hidden, labels, mask, chunk: int):
    b, s = labels.shape
    chunk = min(chunk, s)
    pad = -s % chunk
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=labels.device)
    if pad:
        if hidden is not None:
            hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    return hidden, labels, mask, chunk


def _mask_count(mask, labels, chunk: int) -> torch.Tensor:
    """The chunk loop's mask count, ahead of the forward: each chunk's Σ,
    added in order from 0."""
    _, _, mask, chunk = _padded(None, labels, mask, chunk)
    cnt = torch.zeros((), dtype=torch.float32, device=mask.device)
    for c0 in range(0, mask.shape[1], chunk):
        cnt = cnt + torch.sum(mask[:, c0:c0 + chunk])
    return cnt


def chunked_lm_sums(lm: LM, params, hidden, labels, mask=None,
                    chunk: int = 512, mesh=None, specs=None):
    """hidden [B, S, D] (after the final norm) → (Σ of the CE over the
    mask, Σ mask) without the full logits: S padded to a multiple of
    ``chunk`` (hidden and labels with zeros, the mask with zeros), each
    chunk's head + logsumexp + gold gather under :func:`remat` (on a
    mesh the head gathered inside it), the chunks' sums added in order
    from 0."""
    hidden, labels, mask, chunk = _padded(hidden, labels, mask, chunk)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, hidden.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        extra = () if mesh is None else (mesh, specs)
        t, c = remat(_chunk_ce, lm, params, hidden[:, sl], labels[:, sl],
                     mask[:, sl], *extra)
        tot, cnt = tot + t, cnt + c
    return tot, cnt


def chunked_lm_loss(lm: LM, params, hidden, labels, mask=None,
                    chunk: int = 512):
    """hidden [B, S, D] (after the final norm) → scalar CE without the
    full logits (:func:`chunked_lm_sums`): Σ / max(count, 1)."""
    tot, cnt = chunked_lm_sums(lm, params, hidden, labels, mask, chunk)
    return tot / torch.clamp_min(cnt, 1.0)


def make_loss_fn(lm: LM, *, loss_chunk: int = 512, mesh=None, specs=None):
    """``loss_fn(params, batch) → (ce + aux, {"ce", "aux"})``; ``extra``
    from the batch's ``frames`` (audio) or ``image_embeds`` (vlm). On a
    ``mesh`` (module docstring) the loss returned is this rank's share,
    the one its backward takes, and ``{"ce", "aux", "loss"}`` the whole
    batch's."""
    def loss_fn(params, batch):
        extra = {k: batch[k] for k in ("frames", "image_embeds")
                 if k in batch} or None
        hidden, aux = lm.train_hidden(params, batch["tokens"], extra)
        ce = chunked_lm_loss(lm, params, hidden, batch["labels"],
                             batch.get("mask"), chunk=loss_chunk)
        return ce + aux, {"ce": ce, "aux": aux}

    def mesh_loss_fn(params, batch):
        rows = {k: SH.batch_rows(batch[k], mesh)
                for k in ("tokens", "labels", "mask") if k in batch}
        denom = torch.clamp_min(PM.rank_sum(PM.axis_gather(
            _mask_count(rows.get("mask"), rows["labels"], loss_chunk),
            mesh, "data")), 1.0)
        hidden, aux = lm.train_hidden(params, rows["tokens"], None, mesh,
                                      specs)
        tot, _ = chunked_lm_sums(lm, params, hidden, rows["labels"],
                                 rows.get("mask"), loss_chunk, mesh, specs)
        ce = PM.rank_sum(PM.axis_gather(tot.detach(), mesh, "data")) / denom
        return tot / denom + aux, {"ce": ce, "aux": aux,
                                   "loss": ce + aux.detach()}
    return loss_fn if mesh is None else mesh_loss_fn


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
                    loss_chunk: int = 512, mesh=None, specs=None):
    """``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``; params and state are updated in place (the reference's
    launcher donates them) and returned. ``batch``: ``{"tokens": [B, S]
    int, "labels": [B, S] int, optional "mask": [B, S] f32, optional
    "frames"/"image_embeds"}`` (on a ``mesh`` the global batch; each data
    rank takes its rows). ``metrics``: ``loss``, ``ce``, ``aux``,
    ``grad_norm`` and ``lr``, 0-d tensors on the params' device (not
    read back to the host), the same on every rank of a mesh."""
    loss_fn = make_loss_fn(lm, loss_chunk=loss_chunk, mesh=mesh,
                           specs=specs)

    def train_step(params, opt_state, batch):
        (loss, parts), grads = loss_and_grads(loss_fn, params, batch)
        params, opt_state, om = OPT.adamw_update(opt_cfg, params, grads,
                                                 opt_state, mesh, specs)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step
