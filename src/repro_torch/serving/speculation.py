"""Host-side draft sources for speculative multi-token decode
(``repro/serving/speculation.py``, copied).

The unified engine verifies a k-token draft by riding the speculating
decode row through the SAME ragged forward as a qlen-(k+1) chunk (see
``Engine._forward_step``), so the only new machinery speculation needs
is something that *proposes* the k tokens. This module holds that seam:

* :class:`DraftSource` — the pluggable interface. A draft source is a
  pure host-side oracle: given the request's prompt + generated history
  it returns up to ``k`` proposed next tokens (possibly fewer, possibly
  none). It must be deterministic for a given context — greedy
  speculation-on/-off parity and the recovery journal's bitwise replay
  both depend on the draft plan being a pure function of engine state.
* :class:`PromptLookupDraft` — the default implementation: n-gram
  prompt lookup (PLD). The last ``max_ngram``..``min_ngram`` tokens of
  the context are searched for an earlier occurrence, and the tokens
  that followed that occurrence become the draft. Repetitive contexts
  (code, extractive QA, self-repeating generations) accept most of the
  draft; divergent contexts just fall back to ordinary one-token decode.
  Zero model cost, zero device state — the draft never touches the KV
  pools, only the *verification* chunk does.

A small draft MODEL sharing the engine's page pools would implement the
same interface (propose from its own forward pass); that is the
remaining roadmap gap, and it plugs in here without touching the
engine's verify/rollback path.

This module is deliberately host-only (cometlint rule R6): draft
planning runs in the scheduler phase of every step and must never
trigger device work or retracing.
"""

from __future__ import annotations

__all__ = ["DraftSource", "PromptLookupDraft"]


class DraftSource:
    """Interface for speculative-draft proposers.

    ``draft(prompt, generated, k)`` returns up to ``k`` proposed token
    ids continuing ``prompt + generated``. Returning fewer tokens (or
    an empty list) is always legal — the engine simply verifies a
    shorter chunk, or falls back to plain one-token decode. The engine
    treats the result as untrusted: ids outside the vocab are dropped
    (counted in ``draft_errors``), and a raising source degrades to
    no-draft instead of failing the request.
    """

    def draft(self, prompt: list, generated: list, k: int) -> list:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class PromptLookupDraft(DraftSource):
    """Deterministic n-gram prompt-lookup drafting.

    Searches the request's full context (prompt + generated history)
    for the most recent earlier occurrence of its trailing n-gram,
    longest ``max_ngram`` first, and proposes the tokens that followed
    it. Among occurrences of the same n-gram, the most recent one with
    a full k-token continuation wins (a match near the context tail
    has its continuation clipped by the context end — in a repeating
    run that match would propose a single token, wasting the verify
    chunk); if no occurrence can fill ``k``, the longest available
    continuation is used.

    O(len(context) · max_ngram) per call on plain python lists — the
    context is one request's tokens, and the scan runs once per decode
    step for speculating rows only.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={min_ngram}, max_ngram={max_ngram}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def draft(self, prompt: list, generated: list, k: int) -> list:
        if k <= 0:
            return []
        ctx = list(prompt) + list(generated)
        length = len(ctx)
        for n in range(min(self.max_ngram, length - 1),
                       self.min_ngram - 1, -1):
            pattern = ctx[-n:]
            best: list = []
            for i in range(length - n - 1, -1, -1):
                if ctx[i:i + n] == pattern:
                    cont = ctx[i + n:i + n + k]
                    if len(cont) >= k:
                        return list(cont)
                    if len(cont) > len(best):
                        best = list(cont)
            if best:
                return best
        return []

    def describe(self) -> str:
        return (f"PromptLookupDraft(max_ngram={self.max_ngram}, "
                f"min_ngram={self.min_ngram})")
