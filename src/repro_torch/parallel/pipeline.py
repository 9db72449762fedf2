"""GPipe staging of a layer stack (``repro/parallel/pipeline.py``), in
one process.

The L layers are split into S equal stages; a stream of M microbatches
drains in M + S − 1 ticks. Each tick stage 0 takes microbatch t (zeros
once the stream is drained), every later stage takes its neighbour's
output of the previous tick, and all stages advance, here in turn; the
last stage's output from tick S − 1 on is microbatch t − S + 1's
result. The bubble is (S − 1)/(M + S − 1) of the ticks. Autograd flows
through the schedule. Stages on separate ranks (send/recv between stage
ranks) are not ported (ROADMAP Queue 1 item 20).
"""

from __future__ import annotations

import torch

__all__ = ["stage_params", "pipeline_apply", "pipeline_bubble_fraction"]


def stage_params(layers: list, num_stages: int) -> list:
    """A list of L per-layer blocks → S stages, each a list of L/S."""
    n = len(layers)
    if n % num_stages:
        raise ValueError(f"{n} layers do not split into {num_stages} "
                         f"equal stages")
    per = n // num_stages
    return [layers[s * per:(s + 1) * per] for s in range(num_stages)]


def pipeline_apply(block_fn, staged: list, x_micro: torch.Tensor):
    """x_micro [M, mb, ...] → [M, mb, ...]: the GPipe schedule over the
    stages ``staged`` (:func:`stage_params`); ``block_fn(block, x)``
    applies one layer."""
    num_stages, m = len(staged), x_micro.shape[0]
    zeros = torch.zeros_like(x_micro[0])
    outs = [zeros] * num_stages             # each stage's last output
    drained = []
    for t in range(m + num_stages - 1):
        bufs = [x_micro[t] if t < m else zeros] + outs[:-1]
        outs = []
        for blocks, h in zip(staged, bufs):
            for bp in blocks:
                h = block_fn(bp, h)
            outs.append(h)
        drained.append(outs[-1])
    # microbatch i enters stage 0 at tick i and leaves at tick i + S − 1
    return torch.stack(drained[num_stages - 1:])


def pipeline_bubble_fraction(num_stages: int, num_micro: int) -> float:
    return (num_stages - 1) / (num_micro + num_stages - 1)
