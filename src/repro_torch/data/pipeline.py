"""Deterministic, host-sharded synthetic token stream
(``repro/data/pipeline.py``).

Every batch is a pure function of (seed, step, host): a run restored at
step N draws the same remaining stream as an uninterrupted one, with no
iterator state to checkpoint. The stream is a first-order Markov chain
over a sub-vocabulary of at most 512 tokens with a fixed random
transition table (each token prefers ~8 successors, 10 % of tokens
uniform noise), so a small LM has structure to learn. The numbers come from numpy's
generator with the reference's seeds and loop, so tokens and labels equal
the reference's for any (seed, step, host); only the container differs
(tensors on an explicit device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.layers.common import resolve_device

__all__ = ["DataConfig", "SyntheticLMData"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0


class SyntheticLMData:
    """First-order Markov chain sampler with a fixed random transition table."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = min(cfg.vocab_size, 512)       # structure lives in a sub-vocab
        self.sub_vocab = v
        self.table = rng.integers(0, v, size=(v, 8)).astype(np.int32)

    def host_batch(self, step: int) -> tuple:
        """This host's (tokens, labels) of ``step``: int32 numpy [B/hosts,
        seq_len], labels the tokens shifted by one."""
        cfg = self.cfg
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of num_hosts {cfg.num_hosts}")
        local_b = cfg.global_batch // cfg.num_hosts
        seed = (cfg.seed * 1_000_003 + step) * 4_096 + cfg.host_id
        rng = np.random.default_rng(seed)
        v = self.sub_vocab
        toks = np.empty((local_b, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=local_b)
        choice = rng.integers(0, 8, size=(local_b, cfg.seq_len))
        noise = rng.random((local_b, cfg.seq_len)) < 0.1
        rand_tok = rng.integers(0, v, size=(local_b, cfg.seq_len))
        for t in range(cfg.seq_len):
            nxt = self.table[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return toks[:, :-1], toks[:, 1:]

    def batch_for_step(self, step: int, device="cuda") -> dict:
        """``{"tokens", "labels": int64 [B/hosts, seq_len], "mask": f32
        ones}`` on ``device`` (a CUDA device without a card raises)."""
        dev = resolve_device(device)
        toks, labels = self.host_batch(step)
        return {"tokens": torch.from_numpy(toks).long().to(dev),
                "labels": torch.from_numpy(labels).long().to(dev),
                "mask": torch.ones(toks.shape, dtype=torch.float32,
                                   device=dev)}
