"""Weight-free draft proposers for speculative serving.

Counterpart of ``neuronx_distributed_llama3_2_tpu/serving/drafter.py``
(``DraftProposer``, ``NGramDrafter.propose``), copied: the port keeps its
own copy and imports nothing of the JAX package. The accept rule
(:func:`..inference.speculative.accept_rule`) keeps the emitted stream
token-identical to plain greedy decoding whatever a proposer drafts, so a
proposer is only a throughput knob.

:class:`NGramDrafter` is prompt-lookup decoding: match the sequence's own
trailing n-gram against its earlier history and propose the continuation
that followed last time.

Not ported yet: ``propose_tree`` and ``TreeDrafter`` (the tree slice).
"""

from __future__ import annotations

from typing import List, Protocol, Sequence, runtime_checkable


@runtime_checkable
class DraftProposer(Protocol):
    """Anything that proposes draft tokens for one lane's history."""

    def propose(self, history: Sequence[int], max_tokens: int) -> List[int]:
        """Return up to ``max_tokens`` draft tokens continuing ``history``
        (the lane's prompt + generated tokens so far, newest last). An
        empty list abstains: the lane takes a plain decode step.

        Drafting is advisory: the engine catches any exception escaping
        ``propose`` (counted in ``ServingMetrics.drafter_faults``), treats
        the lane as abstaining for that step and keeps serving."""
        ...


class NGramDrafter:
    """Prompt-lookup drafting: longest-suffix n-gram match against the
    lane's own history.

    For ``n`` from ``max_n`` down to ``min_n``, find the most recent
    earlier occurrence of the history's last ``n`` tokens and propose the
    tokens that followed it. Larger ``n`` first: a longer match is a
    stronger signal, and the first hit wins."""

    def __init__(self, max_n: int = 3, min_n: int = 1) -> None:
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got ({min_n}, {max_n})")
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, history: Sequence[int], max_tokens: int) -> List[int]:
        if max_tokens < 1:
            return []
        h = list(history)
        for n in range(self.max_n, self.min_n - 1, -1):
            if len(h) <= n:
                continue
            tail = h[-n:]
            # latest earlier occurrence; the match may overlap the suffix
            # region (periodic text), only the trailing copy itself is
            # excluded, so the continuation is never empty
            for start in range(len(h) - n - 1, -1, -1):
                if h[start : start + n] == tail:
                    return h[start + n : start + n + max_tokens]
        return []
