"""Medusa decoding: tree-based multi-token speculation with extra LM heads.

Counterpart of ``neuronx_distributed_llama3_2_tpu/inference/medusa.py``
(``DEFAULT_MEDUSA_CHOICES``, ``MedusaBuffers``, ``generate_medusa_buffers``,
``MedusaHeads``, ``MedusaResult``, ``MedusaDecoder``).

- The tree buffers are static numpy, computed once per ``medusa_choices``
  tree.
- Verification is one forward of the whole candidate tree through the
  dense :class:`..inference.model.LlamaDecode` with ``tree=``: tree tokens
  rope at ``position + depth`` and attend their ancestors only.
- The commit is a second forward over the accepted path (at most K
  tokens): it rewrites the accepted tokens' K/V at the true frontier rows
  (the tree rows hold them branch-interleaved).

The emitted tokens are the model's greedy continuation: acceptance keeps
only candidates equal to the base head's argmax.

The JAX package jits Medusa's four helpers (``_prefill_fn``, ``_verify``,
``_commit``, ``_heads_fn``); here they run eagerly, each a plain call of
the decode model or the heads over the engine's dense cache. The heads are
an ``nn.Module`` (:class:`MedusaHeads`) on the port's
``ColumnParallelLinear``; :func:`medusa_params_from_jax` carries the JAX
package's heads pytree across.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
    InferenceEngine,
    pick_bucket,
)
# the same result type as draft speculation
from neuronx_distributed_llama3_2_tpu_torch.inference.speculative import (
    SpeculativeResult as MedusaResult,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.layers import ColumnParallelLinear
from neuronx_distributed_llama3_2_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)

#: the default tree of the Medusa paper (mc_sim_7b_63 style, trimmed)
DEFAULT_MEDUSA_CHOICES: Tuple[Tuple[int, ...], ...] = (
    (0,), (0, 0), (1,), (0, 1), (2,), (0, 0, 0), (1, 0), (0, 2),
)


@dataclasses.dataclass(frozen=True)
class MedusaBuffers:
    """Static tree buffers."""

    # tree_indices[i]: which flat candidate (1 + head*topk + rank) feeds
    # tree slot i; slot 0 is the base-head token
    tree_indices: np.ndarray      # (L,) int32
    depths: np.ndarray            # (L,) int32  (0 for the root)
    ancestor_mask: np.ndarray     # (L, L) bool, diagonal True
    # retrieve_indices[p]: tree slots of root->leaf path p, -1-padded
    retrieve_indices: np.ndarray  # (P, max_depth+1) int32
    topk: int

    @property
    def tree_len(self) -> int:
        return len(self.tree_indices)

    def packed_parents(self) -> np.ndarray:
        """The tree as a packed parents vector, the form the paged engine's
        tree verify (``LlamaDecode.tree_verify_step``) takes:
        ``parents[i]`` is slot ``i``'s parent slot, ``parents[0] == 0``.
        Slots are sorted by (depth, ranks), so parents precede children."""
        parents = np.zeros(self.tree_len, np.int32)
        for i in range(1, self.tree_len):
            anc = np.nonzero(
                self.ancestor_mask[i] & (self.depths == self.depths[i] - 1)
            )[0]
            parents[i] = int(anc[0])
        return parents


def generate_medusa_buffers(
    medusa_choices: Sequence[Sequence[int]] = DEFAULT_MEDUSA_CHOICES,
    topk: int = 10,
) -> MedusaBuffers:
    """Build the static tree from path choices: each choice is a tuple of
    per-head top-k ranks, e.g. (0, 1) = head0's top-1 then head1's top-2."""
    paths = sorted(set(tuple(c) for c in medusa_choices), key=lambda p: (len(p), p))
    if not paths:
        raise ValueError("medusa_choices must be non-empty")
    for p in paths:
        if any(r >= topk for r in p):
            raise ValueError(f"choice {p} exceeds topk={topk}")

    # slot 0 = base token (root); remaining slots = unique path prefixes
    prefixes: List[Tuple[int, ...]] = []
    for p in paths:
        for d in range(1, len(p) + 1):
            pre = p[:d]
            if pre not in prefixes:
                prefixes.append(pre)
    prefixes.sort(key=lambda p: (len(p), p))

    n = 1 + len(prefixes)
    slot_of = {(): 0}
    tree_indices = np.zeros(n, np.int32)
    depths = np.zeros(n, np.int32)
    for i, pre in enumerate(prefixes, start=1):
        slot_of[pre] = i
        tree_indices[i] = 1 + (len(pre) - 1) * topk + pre[-1]
        depths[i] = len(pre)

    mask = np.zeros((n, n), bool)
    for pre, slot in slot_of.items():
        for d in range(len(pre) + 1):
            mask[slot, slot_of[pre[:d]]] = True

    max_d = max(len(p) for p in paths)
    retrieve = np.full((len(paths), max_d + 1), -1, np.int32)
    for pi, p in enumerate(paths):
        for d in range(len(p) + 1):
            retrieve[pi, d] = slot_of[p[:d]]
    return MedusaBuffers(
        tree_indices=tree_indices, depths=depths, ancestor_mask=mask,
        retrieve_indices=retrieve, topk=topk,
    )


class _MedusaHead(nn.Module):
    def __init__(self, hidden_size: int, vocab_size: int, dtype, device) -> None:
        super().__init__()
        self.res = ColumnParallelLinear(
            hidden_size, hidden_size, use_bias=True, dtype=dtype, device=device
        )
        self.lm = ColumnParallelLinear(hidden_size, vocab_size, dtype=dtype, device=device)


class MedusaHeads(nn.Module):
    """K residual-block heads over the final hidden state (the standard
    Medusa head: h + SiLU(W h + b), then an LM head per head). Parameters
    are allocated on ``device`` (the card unless the caller asks for
    another) and left uninitialized: draw them with :meth:`init_weights`
    or load them with :func:`medusa_params_from_jax`."""

    def __init__(
        self, hidden_size: int, vocab_size: int, num_heads: int = 3,
        dtype=torch.float32, device: DeviceLike = "cuda",
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.hidden_size, self.vocab_size, self.num_heads = hidden_size, vocab_size, num_heads
        self.heads = nn.ModuleList(
            _MedusaHead(hidden_size, vocab_size, dtype, dev) for _ in range(num_heads)
        )

    def init_weights(self, seed: int) -> "MedusaHeads":
        """Random weights from ``seed`` (N(0, 0.02) kernels, zero biases),
        drawn on the parameters' own device."""
        dev = self.heads[0].res.kernel.device
        g = torch.Generator(device=dev).manual_seed(seed)
        for h in self.heads:
            h.res.reset_parameters(g)
            h.lm.reset_parameters(g)
        return self

    @torch.no_grad()
    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden (..., H) -> medusa logits (K, ..., V)."""
        outs = []
        for h in self.heads:
            x = hidden + nn.functional.silu(h.res(hidden))
            outs.append(h.lm(x))
        return torch.stack(outs, dim=0)


def medusa_params_from_jax(
    np_params: Mapping[str, Any], hidden_size: int, vocab_size: int,
    dtype=torch.float32, device: DeviceLike = "cuda",
) -> MedusaHeads:
    """The JAX package's ``MedusaHeads.init`` pytree (``{"heads": [{"res":
    {"kernel", "bias"}, "lm": {"kernel"}}, ...]}``, numpy leaves) -> a
    :class:`MedusaHeads` holding the same weights at ``dtype``."""
    heads = np_params["heads"]
    mod = MedusaHeads(hidden_size, vocab_size, len(heads), dtype=dtype, device=device)
    sd = {}
    for i, hp in enumerate(heads):
        sd[f"heads.{i}.res.kernel"] = hp["res"]["kernel"]
        sd[f"heads.{i}.res.bias"] = hp["res"]["bias"]
        sd[f"heads.{i}.lm.kernel"] = hp["lm"]["kernel"]
    dev = resolve_device(device)
    mod.load_state_dict({
        k: torch.tensor(np.asarray(v, dtype=np.float32)).to(device=dev, dtype=dtype)
        for k, v in sd.items()
    })
    return mod


class MedusaDecoder:
    """Greedy Medusa decode of one sequence through an
    :class:`..inference.engine.InferenceEngine`'s model and dense cache
    (slot 0). ``medusa_params`` is the :class:`MedusaHeads` module."""

    def __init__(
        self,
        engine: InferenceEngine,
        medusa_params: MedusaHeads,
        buffers: Optional[MedusaBuffers] = None,
        num_heads: int = 3,
    ) -> None:
        if medusa_params.num_heads != num_heads:
            raise ValueError(
                f"{medusa_params.num_heads} medusa heads given, {num_heads} expected"
            )
        self.engine = engine
        self.heads = medusa_params
        self.buffers = buffers or generate_medusa_buffers()
        if int(self.buffers.depths.max()) > num_heads:
            raise ValueError("tree deeper than the number of medusa heads")

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.int32), device=self.engine.device)

    # -- the forwards ------------------------------------------------------

    @torch.no_grad()
    def _prefill(self, prompt: Sequence[int]) -> Tuple[int, torch.Tensor, int]:
        eng = self.engine
        bucket = pick_bucket(eng.buckets, len(prompt))
        toks = np.zeros((1, bucket), np.int32)
        toks[0, : len(prompt)] = prompt
        logits, hidden, eng.cache = self._fwd_hidden(
            eng.params, eng.cache, self._dev(toks), self._dev([0]), context_encode=True
        )
        greedy = torch.argmax(logits, dim=-1)
        last = len(prompt) - 1
        return int(greedy[0, last]), hidden, last

    @torch.no_grad()
    def _fwd_hidden(self, p, cache, toks, pos, *, context_encode=False, tree=None):
        """Every Medusa forward: the engine's decode model over the cache
        (slot 0), returning (logits, hidden, cache)."""
        p = self.engine._live_params(p)
        hidden, cache = self.engine.model.forward(
            p, cache, toks, pos, context_encode=context_encode, return_hidden=True,
            tree=tree,
        )
        return p._logits(hidden), hidden, cache

    _commit = _fwd_hidden

    # -- one round ---------------------------------------------------------

    def _heads_topk(self, hidden: torch.Tensor, slot: int) -> torch.Tensor:
        """The heads' top-k ids at one hidden slot: (Kh, topk)."""
        med = self.heads(hidden[:, slot])[:, 0]  # (Kh, V)
        return torch.topk(med, self.buffers.topk, dim=-1).indices

    def _candidates(self, base_token: int, topk_ids) -> np.ndarray:
        """Flat candidate pool [base, head0 topk..., head1 topk...] -> tree
        slots."""
        if isinstance(topk_ids, torch.Tensor):
            topk_ids = topk_ids.cpu().numpy()
        flat = np.concatenate([[base_token], np.asarray(topk_ids).reshape(-1)])
        return flat[self.buffers.tree_indices].astype(np.int32)

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 64) -> MedusaResult:
        """The round protocol (the newest emitted token is the uncommitted
        root of the next round's tree):

        - verify: forward [root, candidates...] in tree mode at positions
          ``pos + depth``; slot 0 (the root, depth 0) lands at its true
          row ``pos``, the candidate rows past it are branch-interleaved.
        - accept: the longest path whose every candidate equals the greedy
          continuation of its parent slot; the bonus is the greedy of the
          last accepted slot, and the next round's heads read the verify
          pass's hidden state at that slot.
        - commit: when tokens were accepted, rewrite them at rows
          ``pos+1..`` (a fixed K-token block; its padding rows land past
          the new frontier, hidden by the mask until overwritten).
        """
        eng = self.engine
        bufs = self.buffers
        n_tree = bufs.tree_len
        k_max = int(bufs.depths.max())  # most acceptable tokens a round
        # every round's verify writes n_tree rows past the frontier: refuse
        # an over-capacity request up front
        if len(prompt) + max_new_tokens - 1 + n_tree > eng.cache.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} + "
                f"tree {n_tree} exceeds cache capacity {eng.cache.max_len}"
            )
        base, hidden, last = self._prefill(prompt)
        topk_ids = self._heads_topk(hidden, last)
        out: List[int] = [base]
        accepted_hist: List[int] = []
        pos = len(prompt)  # committed rows; out[-1] is the uncommitted root

        tree = (self._dev(bufs.depths), torch.as_tensor(bufs.ancestor_mask, device=eng.device))
        retrieve = np.asarray(bufs.retrieve_indices)

        while len(out) < max_new_tokens:
            # the verify writes must fit the cache rows
            if pos + n_tree > eng.cache.max_len:
                break
            tree_tokens = self._candidates(out[-1], topk_ids)
            logits, hidden, eng.cache = self._fwd_hidden(
                eng.params, eng.cache, self._dev(tree_tokens[None, :]), self._dev([pos]),
                tree=tree,
            )
            greedy = torch.argmax(logits[0], dim=-1).cpu().numpy()  # (L,)

            # greedy acceptance over root->leaf paths: the candidate at
            # depth d survives iff it equals the model's greedy
            # continuation of its parent slot, consecutively
            best_len, best_path = 0, 0
            for pi in range(retrieve.shape[0]):
                path = retrieve[pi]
                n = 0
                for d in range(1, path.shape[0]):
                    slot = int(path[d])
                    if slot < 0:
                        break
                    if int(tree_tokens[slot]) == int(greedy[int(path[d - 1])]):
                        n += 1
                    else:
                        break
                if n > best_len:
                    best_len, best_path = n, pi

            path = retrieve[best_path]
            accepted = [int(tree_tokens[path[d]]) for d in range(1, best_len + 1)]
            last_slot = int(path[best_len])
            bonus = int(greedy[last_slot])
            accepted_hist.append(best_len)

            if best_len > 0:
                # fixed-shape commit: K tokens, padded by repeating the last
                # accepted token
                block = accepted + [accepted[-1]] * (k_max - best_len)
                _, _, eng.cache = self._commit(
                    eng.params, eng.cache, self._dev([block]), self._dev([pos + 1]),
                )
            out.extend(accepted + [bonus])
            pos += 1 + best_len  # root + accepted committed; bonus = new root
            topk_ids = self._heads_topk(hidden, last_slot)

        return MedusaResult(tokens=out[:max_new_tokens], accepted_per_round=accepted_hist)
