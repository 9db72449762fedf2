"""Request-lifecycle value types (``repro/serving/api.py``).

The verbs live on ``Engine``: ``submit(prompt, params) -> RequestHandle``,
``step()``, ``stream(handle)``, ``events()``, ``abort(handle)``,
``release(handle)``, ``result(handle)``, and the batch wrapper
``add_request`` + ``run``.

Lifecycle::

    QUEUED → PREFILLING → DECODING → FINISHED(stop_reason)
       │         ├────────────┴────→ FAILED(error)   (step-level fault)
       ├─────────┴────────────┴────→ TIMED_OUT       (deadline/TTFT)
       └─────────┴────────────┴────→ ABORTED         (abort() anywhere)

``FAILED`` also carries two policy reasons: ``"queue_full"`` (submitted
against a full bounded waiting queue; the handle comes back terminal) and
``"shed"`` (a preemption victim dropped because re-queueing it would
overflow that queue). Every sampled token is emitted exactly once, in
order; every request emits exactly one terminal event, always last.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

__all__ = ["SamplingParams", "RequestState", "RequestOutput",
           "RequestHandle"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature: 0 = greedy (argmax); > 0 samples from the top ``top_k``
        logits at that temperature, keyed by (request id, position), so a
        rerun draws the same tokens (``serving/sampling.py``).
    top_k: the candidates a stochastic row samples from.
    deadline_ms: budget for the whole request from submit; past it the
        request expires to ``TIMED_OUT`` (``"deadline"``) at the next step
        boundary, partial output kept. ``None`` = no deadline.
    ttft_ms: budget for the first token from submit (``"ttft_budget"``).
        ``None`` = no budget.
    speculation: speculative-decode draft length k (0 = off, the
        default). Each decode step the engine drafts up to k tokens
        from its host-side draft source (n-gram prompt lookup by
        default) and verifies them in ONE forward as a qlen-(k+1)
        chunk; greedy verification is exact-match, so the emitted text
        is what speculation-off would emit, in fewer forwards.
        Stochastic requests verify by rejection sampling (the output
        *distribution* is exact; the sampled text may differ from the
        non-speculative sampler). Must fit the engine's per-step token
        budget: ``Engine.submit`` rejects k + 1 >
        ``prefill_chunk_tokens``. With ``max_new_tokens == 1`` (or one
        token remaining) drafting silently no-ops — there is nothing
        left to speculate (counted in ``Engine.spec_noop_count``).
    """

    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 40
    deadline_ms: Optional[float] = None
    ttft_ms: Optional[float] = None
    speculation: int = 0

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.speculation < 0:
            raise ValueError("speculation must be >= 0 (0 = off)")
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 1:
            raise ValueError("top_k must be >= 1")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0 (None = no deadline)")
        if self.ttft_ms is not None and self.ttft_ms <= 0:
            raise ValueError("ttft_ms must be > 0 (None = no budget)")


class RequestState(str, enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    ABORTED = "aborted"
    FAILED = "failed"            # step-level fault, "queue_full" or "shed"
    TIMED_OUT = "timed_out"      # deadline_ms / ttft_ms expired

    @property
    def terminal(self) -> bool:
        return self in (RequestState.FINISHED, RequestState.ABORTED,
                        RequestState.FAILED, RequestState.TIMED_OUT)


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """One streamed event: a sampled token (``token is not None``) or the
    terminal event (``finished``)."""

    request_id: int
    state: RequestState
    token: Optional[int] = None
    num_generated: int = 0
    stop_reason: Optional[str] = None
    finished: bool = False


@dataclasses.dataclass(frozen=True)
class RequestHandle:
    """Ticket returned by ``Engine.submit``."""

    request_id: int
    prompt_len: int = 0
