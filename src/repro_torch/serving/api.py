"""Request-lifecycle value types (``repro/serving/api.py``).

The verbs live on ``Engine``: ``submit(prompt, params) -> RequestHandle``,
``step()``, ``stream(handle)``, ``events()``, ``abort(handle)``,
``release(handle)``, ``result(handle)``, and the batch wrapper
``add_request`` + ``run``.

Lifecycle::

    QUEUED → PREFILLING → DECODING → FINISHED(stop_reason)
       │         ├────────────┴────→ FAILED(error)   (step-level fault)
       └─────────┴────────────┴────→ ABORTED         (abort() anywhere)

Every sampled token is emitted exactly once, in order; every request
emits exactly one terminal event, always last.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

__all__ = ["SamplingParams", "RequestState", "RequestOutput",
           "RequestHandle"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration. Only greedy decoding is
    ported; temperature/top-k sampling and deadlines come with a later
    slice."""

    max_new_tokens: int = 16

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


class RequestState(str, enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    ABORTED = "aborted"
    FAILED = "failed"

    @property
    def terminal(self) -> bool:
        return self in (RequestState.FINISHED, RequestState.ABORTED,
                        RequestState.FAILED)


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
