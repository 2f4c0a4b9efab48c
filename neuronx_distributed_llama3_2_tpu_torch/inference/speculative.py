"""The speculative accept/reject rule.

Counterpart of ``neuronx_distributed_llama3_2_tpu/inference/speculative.py``
(``accept_rule``), on torch tensors. The verify step scores the block
``[cur, d_0 .. d_{k-1}]`` in one block-causal forward and keeps the
longest draft prefix that agrees with the target's greedy choice, plus one
correction (or bonus) token. Rejected rows past the accepted frontier need
no rollback: the block-causal mask never looks past the frontier, so the
next step overwrites them.

Not ported yet: ``tree_topology`` and ``tree_accept_rule`` (the tree
slice) and the draft-model ``SpeculativeDecoder`` (the dense-engine slice).
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
