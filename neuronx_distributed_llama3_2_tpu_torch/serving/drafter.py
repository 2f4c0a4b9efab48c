"""Weight-free draft proposers for speculative serving.

Counterpart of ``neuronx_distributed_llama3_2_tpu/serving/drafter.py``
(``DraftProposer``, ``NGramDrafter``, ``TreeDrafter``), copied: the port
keeps its own copy and imports nothing of the JAX package. The accept rules
(:func:`..inference.speculative.accept_rule` for chains,
:func:`..inference.speculative.tree_accept_rule` for packed trees) keep the
emitted stream token-identical to plain greedy decoding whatever a
proposer drafts, so a proposer is only a throughput knob.

:class:`NGramDrafter` is prompt-lookup decoding: match the sequence's own
trailing n-gram against its earlier history and propose the continuation
that followed last time.

Tree speculation (``PagedConfig.spec_tree``) asks a drafter for the
optional ``propose_tree(history, max_nodes, branches)``: a packed
candidate tree rooted at the lane's resident token (returned token ``i`` is
packed node ``i + 1``, ``parents[i]`` its parent's packed index, 0 the
root). :class:`NGramDrafter` branches on the continuations of its match
sites; :class:`TreeDrafter` gives any chain-only drafter the method.
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, Tuple, runtime_checkable


@runtime_checkable
class DraftProposer(Protocol):
    """Anything that proposes draft tokens for one lane's history. It may
    also offer ``propose_tree`` (see :meth:`TreeDrafter.propose_tree`); the
    engine looks it up with ``getattr``."""

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

    def _continuations(
        self, h: List[int], max_tokens: int, want: int
    ) -> List[List[int]]:
        """Up to ``want`` match-site continuations, best first, in
        :meth:`propose`'s order (longest n first, latest site first), so
        entry 0 is the :meth:`propose` chain; shorter n only when longer
        matches did not fill the quota. Sites are not deduplicated by first
        token: the trie of :meth:`propose_tree` merges shared prefixes, so
        an earlier site with the same first token deepens the primary
        chain and a divergent one opens a branch."""
        conts: List[List[int]] = []
        for n in range(self.max_n, self.min_n - 1, -1):
            if len(h) <= n or len(conts) >= want:
                continue
            tail = h[-n:]
            for start in range(len(h) - n - 1, -1, -1):
                if h[start : start + n] != tail:
                    continue
                cont = h[start + n : start + n + max_tokens]
                if cont:
                    conts.append(cont)
                    if len(conts) >= want:
                        break
        return conts

    def propose_tree(
        self, history: Sequence[int], max_nodes: int, branches: int = 2
    ) -> Tuple[List[int], List[int]]:
        """The continuations of up to ``branches`` match sites packed into
        a token trie rooted at the resident token, the :meth:`propose`
        chain first and whole, so the tree always holds it as its leftmost
        path; at ``branches == 1`` the tree is that chain. Returns
        ``(tokens, parents)`` in packed node space: token ``i`` is node
        ``i + 1`` and ``parents[i]`` its parent's index (0 = the root),
        parents before children."""
        if max_nodes < 1 or branches < 1:
            return [], []
        conts = self._continuations(list(history), max_nodes, branches)
        tokens: List[int] = []
        parents: List[int] = []
        children: dict = {}  # (parent packed index, token) -> packed index
        for cont in conts:
            node = 0  # the root
            for tok in cont:
                nxt = children.get((node, tok))
                if nxt is None:
                    if len(tokens) >= max_nodes:
                        break
                    tokens.append(tok)
                    parents.append(node)
                    nxt = children[(node, tok)] = len(tokens)
                node = nxt
        return tokens, parents


class TreeDrafter:
    """Gives any :class:`DraftProposer` the ``propose_tree`` method: it
    delegates to the inner drafter's own ``propose_tree`` (with this
    adapter's default ``branches``) where there is one, else proposes the
    inner chain as a one-branch tree (``parents[i] = i``), which the tree
    accept rule scores as the linear verify does."""

    def __init__(self, inner: DraftProposer, branches: int = 2) -> None:
        if branches < 1:
            raise ValueError(f"branches must be >= 1, got {branches}")
        self.inner = inner
        self.branches = branches

    def propose(self, history: Sequence[int], max_tokens: int) -> List[int]:
        return self.inner.propose(history, max_tokens)

    def propose_tree(
        self,
        history: Sequence[int],
        max_nodes: int,
        branches: Optional[int] = None,
    ) -> Tuple[List[int], List[int]]:
        b = self.branches if branches is None else branches
        inner_tree = getattr(self.inner, "propose_tree", None)
        if inner_tree is not None:
            return inner_tree(history, max_nodes, b)
        chain = list(self.inner.propose(history, max_nodes))
        return chain, list(range(len(chain)))
