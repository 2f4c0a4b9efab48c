"""Radix prefix index: token prefixes -> KV block chains.

SGLang's RadixAttention (Zheng et al., 2024) applied to the block pool: a
trie whose nodes each own ONE pool block, keyed by the (at most
``block_size``) tokens whose KV that block holds. A new request walks the
trie with its prompt and takes the matched chain *by reference* — those
tokens are never re-prefilled; the engine reports them as
``cached_tokens``.

Matching is token-granular: a request may match only the first few tokens
of a node's key, in which case it shares the block's leading rows and the
first write into the block (its own continuation) triggers copy-on-write
in the allocator. Registration happens through :meth:`insert` after a
request's KV is materialized; it marks blocks in the
:class:`.block_allocator.BlockAllocator` so their contents survive request
teardown (parked in the cached LRU) until evicted.

Eviction is allocator-driven: when the pool needs a cached block back, the
allocator calls :meth:`on_block_evicted`, which unlinks the owning node
and its whole subtree (a chain below a missing prefix is unreachable) and
returns the subtree's block ids for the allocator to free.

With a host tier attached (``spill_enabled``), eviction has a third
outcome: the node survives in a *spilled* residency state — its ``block``
becomes the :data:`SPILLED_BLOCK` sentinel and ``sid`` names the payload
in the :class:`.block_allocator.HostTier`. A spilled node keeps its whole
subtree reachable. :meth:`match` stops at the first spilled node (the
engine decides whether restoring pays via the cost-model crossover);
:meth:`walk` is the spill-aware variant that returns the full node chain
so the engine can restore the spilled run H2D and :meth:`heal` the nodes
back to resident blocks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from neuronx_distributed_llama3_2_tpu_torch.serving.block_allocator import (
    BlockAllocator,
)

# Residency sentinel: a node whose device block was evicted but whose
# payload lives in the host tier. Negative so it can never collide with a
# pool id (pool ids are >= 1; the root uses -1).
SPILLED_BLOCK = -2


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class _Node:
    __slots__ = ("key", "block", "children", "parent", "sid")

    def __init__(self, key: Tuple[int, ...], block: int, parent: "_Node"):
        self.key = key
        self.block = block
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent
        self.sid = -1  # host-tier spill id when block == SPILLED_BLOCK


class RadixPrefixIndex:
    """Block-granular radix trie over token sequences.

    Invariant: only nodes with a full ``block_size`` key have children (a
    partially-filled block cannot be extended in place — extending a prefix
    mid-block goes through :meth:`insert`'s leaf-upgrade path instead).
    """

    def __init__(self, allocator: BlockAllocator) -> None:
        self.alloc = allocator
        self._root = _Node((), -1, None)  # type: ignore[arg-type]
        self._by_block: Dict[int, _Node] = {}
        allocator.on_evict = self.on_block_evicted
        # spilled residency: sid -> node (block == SPILLED_BLOCK). The
        # engine wires on_spill_drop to HostTier.drop so discarding a
        # spilled node also forgets its host payload.
        self._spilled: Dict[int, _Node] = {}
        self.on_spill_drop: Optional[Callable[[int], None]] = None
        # stats for the prefix hit-rate metric
        self.lookups = 0
        self.query_tokens = 0
        self.hit_tokens = 0

    @property
    def num_nodes(self) -> int:
        return len(self._by_block)

    @property
    def num_spilled(self) -> int:
        return len(self._spilled)

    def _drop_sid(self, sid: int) -> None:
        self._spilled.pop(sid, None)
        if self.on_spill_drop is not None:
            self.on_spill_drop(sid)

    def hit_rate(self) -> float:
        """Fraction of looked-up prompt tokens admitted by reference."""
        return self.hit_tokens / self.query_tokens if self.query_tokens else 0.0

    # -- lookup ------------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens``: returns
        ``(matched_tokens, block_ids)`` where the blocks cover the matched
        tokens in order (the last one possibly only partially — token-level
        match inside a block is allowed, the sharer COWs before writing).

        Does NOT take references; the caller must ``incref`` the blocks it
        keeps *before* allocating anything else, or its own allocations may
        evict them.
        """
        bs = self.alloc.block_size
        node, matched, blocks = self._root, 0, []
        self.lookups += 1
        self.query_tokens += len(tokens)
        while matched < len(tokens):
            chunk = tuple(tokens[matched : matched + bs])
            best, best_c = None, 0
            for key, child in node.children.items():
                c = _common_prefix(key, chunk)
                if c > best_c:
                    best, best_c = child, c
            if best is None:
                break
            if best.block == SPILLED_BLOCK:
                break  # spilled residency: restoring is the engine's call
            blocks.append(best.block)
            matched += best_c
            if best_c < len(best.key) or len(best.key) < bs:
                break  # partial within-block match (or partial leaf) ends it
            node = best
        self.hit_tokens += matched
        return matched, blocks

    def walk(self, tokens: Sequence[int]) -> Tuple[int, List[_Node]]:
        """Spill-aware :meth:`match`: the longest prefix walk *including*
        spilled nodes, returned as the node chain itself. No stats, no
        refs — this is the engine's restore-decision probe: it prices the
        spilled run (restore bytes vs recompute FLOPs) and, when restoring
        wins, uploads payloads and :meth:`heal`\\ s the chain before
        re-running :meth:`match` for the request's real admission."""
        bs = self.alloc.block_size
        node, matched, chain = self._root, 0, []
        while matched < len(tokens):
            chunk = tuple(tokens[matched : matched + bs])
            best, best_c = None, 0
            for key, child in node.children.items():
                c = _common_prefix(key, chunk)
                if c > best_c:
                    best, best_c = child, c
            if best is None:
                break
            chain.append(best)
            matched += best_c
            if best_c < len(best.key) or len(best.key) < bs:
                break
            node = best
        return matched, chain

    # -- registration ------------------------------------------------------

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Register a materialized chain: ``blocks[i]`` holds the KV of
        ``tokens[i*bs : (i+1)*bs]``. Existing nodes (shared prefix) are
        reused; new nodes register their blocks with the allocator. A
        partial leaf whose key is a proper prefix of the incoming chunk is
        *upgraded* to the fuller block (the old block is unregistered).
        Returns the number of newly registered blocks."""
        bs = self.alloc.block_size
        node, i, new = self._root, 0, 0
        while i * bs < len(tokens):
            chunk = tuple(tokens[i * bs : (i + 1) * bs])
            if i >= len(blocks):
                break
            child = node.children.get(chunk)
            if child is not None:
                if child.block == SPILLED_BLOCK:
                    # the request just re-materialized this chunk's KV —
                    # heal the spilled node onto the fresh block (the host
                    # payload is now redundant and is dropped)
                    bid = blocks[i]
                    if bid in self._by_block:
                        break
                    self.heal(child, bid)
                    new += 1
                node = child
                i += 1
                if len(chunk) < bs:
                    break  # partial tail node stays a leaf
                continue
            # leaf-upgrade: an existing partial leaf covering a strict
            # prefix of this chunk is superseded by the fuller block
            for key, ch in list(node.children.items()):
                c = _common_prefix(key, chunk)
                if c == len(key) < len(chunk) and not ch.children:
                    del node.children[key]
                    if ch.block == SPILLED_BLOCK:
                        self._drop_sid(ch.sid)
                    else:
                        self._by_block.pop(ch.block, None)
                        self.alloc.unregister(ch.block)
                    break
            bid = blocks[i]
            if bid in self._by_block:
                # same physical block already mapped elsewhere (shared
                # chain diverged then re-registered) — never remap
                break
            nn = _Node(chunk, bid, node)
            node.children[chunk] = nn
            self._by_block[bid] = nn
            self.alloc.register(bid)
            new += 1
            if len(chunk) < bs:
                break
            node = nn
            i += 1
        return new

    # -- spilled residency -------------------------------------------------

    def mark_spilled(self, bid: int, sid: int) -> bool:
        """Move a node from resident to spilled: the device block is gone
        (the allocator recycles it) but the payload lives on under ``sid``
        in the host tier, keeping the node — and its subtree — matchable.
        False when ``bid`` has no node (nothing retained)."""
        node = self._by_block.pop(bid, None)
        if node is None:
            return False
        node.block = SPILLED_BLOCK
        node.sid = sid
        self._spilled[sid] = node
        return True

    def heal(self, node: _Node, bid: int) -> None:
        """Rebind a spilled node to a resident block (restore landed, or
        :meth:`insert` re-materialized the chunk). Registers the block so
        it parks in the cached LRU at refcount zero; the host payload is
        dropped via ``on_spill_drop`` (a restore has already popped it —
        the drop is then a no-op)."""
        sid = node.sid
        node.block = bid
        node.sid = -1
        self._by_block[bid] = node
        self.alloc.register(bid)
        self._drop_sid(sid)

    def invalidate_spilled(self, sid: int) -> None:
        """Drop a spilled node whose payload is gone (host-tier budget
        eviction or an injected host-tier fault): unlink it and discard the
        subtree — resident descendants are unregistered (parked blocks
        return to the free list), spilled descendants lose their payloads
        too. Safe to call re-entrantly from HostTier eviction."""
        node = self._spilled.pop(sid, None)
        if node is None:
            return
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        stack = [node]
        while stack:
            n = stack.pop()
            if n.block == SPILLED_BLOCK:
                if n.sid != sid:
                    self._drop_sid(n.sid)
            else:
                self._by_block.pop(n.block, None)
                self.alloc.unregister(n.block)
            stack.extend(n.children.values())
        if self.on_spill_drop is not None:
            self.on_spill_drop(sid)

    # -- eviction ----------------------------------------------------------

    def on_block_evicted(self, bid: int) -> List[int]:
        """Allocator hook: the LRU victim's node and its whole subtree leave
        the trie. Returns the *descendant* block ids (the victim itself is
        already in the allocator's hands). Spilled descendants are dropped
        through ``on_spill_drop`` instead — they hold no pool id."""
        node = self._by_block.pop(bid, None)
        if node is None:
            return []
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        dropped: List[int] = []
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            if n.block == SPILLED_BLOCK:
                self._drop_sid(n.sid)
            else:
                self._by_block.pop(n.block, None)
                dropped.append(n.block)
            stack.extend(n.children.values())
        return dropped
