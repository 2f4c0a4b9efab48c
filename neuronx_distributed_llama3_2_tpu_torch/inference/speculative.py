"""The speculative accept/reject rules, linear and tree.

Counterpart of ``neuronx_distributed_llama3_2_tpu/inference/speculative.py``
(``accept_rule``, ``tree_topology``, ``tree_accept_rule``), on torch
tensors. The verify step scores the block ``[cur, d_0 .. d_{k-1}]`` in one
block-causal forward and keeps the longest draft prefix that agrees with
the target's greedy choice, plus one correction (or bonus) token. Rejected
rows past the accepted frontier need no rollback: the block-causal mask
never looks past the frontier, so the next step overwrites them. Tree
speculation scores a packed candidate tree instead (node 0 the resident
token, parents before children) and keeps the deepest accepted
root-anchored path.

Not ported yet: the draft-model ``SpeculativeDecoder`` (the dense-engine
slice).
"""

from __future__ import annotations

from typing import Optional, Tuple

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
