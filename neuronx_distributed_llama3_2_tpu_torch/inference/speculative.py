"""Speculative decoding: the accept/reject rules, linear and tree, and the
draft-model decoder.

Counterpart of ``neuronx_distributed_llama3_2_tpu/inference/speculative.py``
(``accept_rule``, ``tree_topology``, ``tree_accept_rule``,
``SpeculativeResult``, ``SpeculativeDecoder``), on torch tensors. The
verify step scores the block ``[cur, d_0 .. d_{k-1}]`` in one
block-causal forward and keeps the longest draft prefix that agrees with
the target's greedy choice, plus one correction (or bonus) token. Rejected
rows past the accepted frontier need no rollback: the block-causal mask
never looks past the frontier, so the next step overwrites them. Tree
speculation scores a packed candidate tree instead (node 0 the resident
token, parents before children) and keeps the deepest accepted
root-anchored path.

:class:`SpeculativeDecoder` runs the rule over two dense engines
(:class:`..inference.engine.InferenceEngine`): the draft engine's B=1
decode program proposes ``gamma`` tokens, the target's verify program
scores them in one forward, and the output is the target's greedy stream.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch


def accept_rule(
    drafts: torch.Tensor,                      # (..., k) int
    greedy: torch.Tensor,                      # (..., k+1) int
    draft_len: Optional[torch.Tensor] = None,  # (...,) int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy accept rule (Leviathan et al. 2023) as one batched
    function. ``greedy[..., j]`` is the target's choice for the position
    right after draft ``j - 1``; ``draft_len`` caps acceptance per row
    (``None``: all k drafts are real).

    Returns ``(accept (...,) int32, emitted (..., k+1) int32)``:
    ``accept`` is the length of the longest agreeing draft prefix and
    ``emitted[..., :accept + 1]`` the committed tokens, the accepted drafts
    followed by ``greedy[..., accept]``. Entries past ``accept`` are
    meaningless."""
    drafts = drafts.to(torch.int32)
    greedy = greedy.to(torch.int32)
    k = drafts.shape[-1]
    match = drafts == greedy[..., :k]
    if draft_len is not None:
        idx_k = torch.arange(k, dtype=torch.int32, device=drafts.device)
        match = match & (idx_k < draft_len.to(torch.int32)[..., None])
    # longest all-True prefix: the cumulative product zeroes everything
    # after the first miss
    accept = torch.cumprod(match.to(torch.int32), dim=-1).sum(dim=-1).to(torch.int32)
    cand = torch.cat([drafts, torch.zeros_like(greedy[..., :1])], dim=-1)
    idx = torch.arange(k + 1, dtype=torch.int32, device=drafts.device)
    emitted = torch.where(idx < accept[..., None], cand, greedy)
    return accept, emitted


def tree_topology(parents: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(depths (..., t) int32, ancestors (..., t, t) bool)`` of packed
    parent pointers ``parents (..., t)``: node ``j >= 1``'s parent index,
    clipped into ``[0, j - 1]`` (packed trees put parents before children);
    ``parents[..., 0]`` is ignored, node 0 is the root. ``ancestors[...,
    j, m]`` is True iff node ``m`` is an ancestor-or-self of node ``j``, so
    every node's ancestors precede it. Each batch row is its own tree."""
    parents = parents.to(torch.int64)
    t = parents.shape[-1]
    lead = parents.shape[:-1]
    iota = torch.arange(t, device=parents.device)
    depths = torch.zeros(lead + (t,), dtype=torch.int32, device=parents.device)
    anc = torch.zeros(lead + (t, t), dtype=torch.bool, device=parents.device)
    anc[..., 0, 0] = True
    for j in range(1, t):
        pj = parents[..., j].clamp(0, j - 1)
        depths[..., j] = torch.gather(depths, -1, pj[..., None])[..., 0] + 1
        row = torch.gather(anc, -2, pj[..., None, None].expand(lead + (1, t)))[..., 0, :]
        anc[..., j, :] = row | (iota == j)
    return depths, anc


def tree_accept_rule(
    tokens: torch.Tensor,                        # (..., t) int
    targets: torch.Tensor,                       # (..., t) int
    parents: torch.Tensor,                       # (..., t) int
    node_len: Optional[torch.Tensor] = None,     # (...,) int
    topology: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The accept rule on a packed tree. ``tokens`` are the scored nodes
    (node 0 the resident root), ``targets[..., j]`` the target's choice for
    the row after node ``j``, ``node_len`` marks nodes ``>= node_len`` as
    padding (the root is always live), ``topology`` is
    :func:`tree_topology` of ``parents`` when the caller has it.

    A draft node is accepted iff its token is the target's continuation of
    its parent and its parent is accepted (the root is); on a chain this is
    :func:`accept_rule`. Returns ``(accept (...,) int32, emitted (..., t)
    int32, best (...,) int32)``: ``accept`` is the depth of the deepest
    accepted node, ``best`` its index (equal depths break to the lowest
    index, the drafter's primary branch) and ``emitted[..., :accept + 1]``
    the root-to-best path's draft tokens followed by ``targets[...,
    best]``. Entries past ``accept`` are meaningless."""
    tokens = tokens.to(torch.int32)
    targets = targets.to(torch.int32)
    parents = parents.to(torch.int64)
    t = tokens.shape[-1]
    depths, anc = topology if topology is not None else tree_topology(parents)
    iota = torch.arange(t, dtype=torch.int32, device=tokens.device)
    accd = torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    accd[..., 0] = True
    for j in range(1, t):
        pj = parents[..., j].clamp(0, j - 1)[..., None]
        parent_ok = torch.gather(accd, -1, pj)[..., 0]
        tgt = torch.gather(targets, -1, pj)[..., 0]
        accd[..., j] = parent_ok & (tokens[..., j] == tgt)
    if node_len is not None:
        live = iota < node_len.to(torch.int32)[..., None]
        accd = accd & (live | (iota == 0))
    eff = torch.where(accd, depths, torch.full_like(depths, -1))
    accept = eff.max(dim=-1).values.to(torch.int32)
    # torch.argmax returns the first of equal maxima: the lowest index
    best = torch.argmax(eff, dim=-1).to(torch.int32)
    t_idx = best.long()[..., None, None].expand(best.shape + (1, t))
    path = torch.gather(anc, -2, t_idx)[..., 0, :]              # (..., t)
    # emitted slot d holds the path's node at depth d + 1
    on_depth = path[..., None, :] & (depths[..., None, :] == (iota[:, None] + 1))
    emitted = torch.where(on_depth, tokens[..., None, :], torch.zeros_like(tokens)[..., None, :])
    emitted = emitted.sum(dim=-1).to(torch.int32)
    bonus = torch.gather(targets, -1, best.long()[..., None])
    emitted = torch.where(iota == accept[..., None], bonus, emitted)
    return accept, emitted, best


@dataclasses.dataclass
class SpeculativeResult:
    tokens: List[int]
    accepted_per_round: List[int]  # acceptance telemetry

    @property
    def mean_accepted(self) -> float:
        if not self.accepted_per_round:
            return 0.0
        return sum(self.accepted_per_round) / len(self.accepted_per_round)


class SpeculativeDecoder:
    """Greedy speculative decode of a single sequence over two dense
    engines (slot 0 of each cache). The output is the target's plain
    greedy decode, whatever the draft proposes.

    Each round the draft's B=1 decode program proposes ``gamma`` tokens
    one by one, the target's verify program scores ``[cur, d_0 ..
    d_{gamma-1}]`` in one forward, and :func:`accept_rule` keeps the
    longest agreeing prefix plus one correction or bonus token. The
    draft may share the target's weights (e.g. its first layers)."""

    def __init__(self, target, draft, gamma: int = 4) -> None:
        from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import (
            SamplingConfig,
        )

        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        self.target = target
        self.draft = draft
        self.gamma = gamma
        self._greedy = SamplingConfig(greedy=True)

    def _prefill(self, engine, prompt: Sequence[int]) -> int:
        return int(engine.prefill_batch([prompt], [0], self._greedy)[0])

    def generate(
        self, prompt: Sequence[int], max_new_tokens: int, eos_token_id=None
    ) -> SpeculativeResult:
        from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
            read_host_tokens,
        )

        target, draft, g = self.target, self.draft, self.gamma
        # every verify round writes up to g+1 rows past the frontier, so
        # the whole run must fit both caches
        if len(prompt) + max_new_tokens + g + 1 > target.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"+ gamma+1 ({g + 1}) exceeds target cache capacity "
                f"({target.max_seq_len})"
            )
        if len(prompt) + max_new_tokens + g + 1 > draft.max_seq_len:
            raise ValueError(
                f"speculation run exceeds draft cache capacity "
                f"({draft.max_seq_len})"
            )
        decode_d = draft._decode_program(1, self._greedy)
        verify_t = target._verify_program(1, g + 1)

        t0 = self._prefill(target, prompt)
        self._prefill(draft, prompt)

        out: List[int] = [t0]
        accepted_log: List[int] = []
        # `cur` = newest emitted token, not yet written to either cache;
        # `pos` = its write position (= number of committed cache rows)
        cur = t0
        pos = len(prompt)

        while len(out) < max_new_tokens:
            if eos_token_id is not None and out[-1] == eos_token_id:
                break
            # 1) the draft proposes gamma tokens autoregressively
            drafts: List[int] = []
            dtok, dpos = cur, pos
            for _ in range(g):
                toks, _ = draft._load(decode_d, tokens=[dtok], positions=[dpos])()
                dtok = int(read_host_tokens(toks)[0])
                drafts.append(dtok)
                dpos += 1

            # 2) the target scores [cur, d_0..d_{g-1}] in one forward
            (logits,) = target._load(
                verify_t, tokens=[[cur] + drafts], positions=[pos]
            )()
            # greedy[i] = the target's token for position pos+i+1
            greedy = read_host_tokens(torch.argmax(logits[0], dim=-1))

            # 3) the longest agreeing prefix + one correction/bonus token
            a_arr, em_arr = accept_rule(
                torch.as_tensor(drafts)[None, :], torch.as_tensor(greedy)[None, :]
            )
            a = int(a_arr[0])
            emitted = [int(x) for x in em_arr[0, : a + 1]]
            accepted_log.append(a)
            if a == g:
                # full acceptance: the draft wrote rows pos..pos+g-1 ([cur,
                # d_0..d_{g-2}]) but never d_{g-1}'s K/V at row pos+g, which
                # the next round's mask admits: one throwaway draft decode
                # writes it
                draft._load(decode_d, tokens=[drafts[-1]], positions=[pos + g])()
            for tok in emitted:
                out.append(tok)
                if eos_token_id is not None and tok == eos_token_id:
                    break
                if len(out) >= max_new_tokens:
                    break
            cur = out[-1]
            pos = pos + a + 1
            if pos + g + 1 >= target.max_seq_len:
                break

        return SpeculativeResult(
            tokens=out[:max_new_tokens], accepted_per_round=accepted_log
        )
