"""The port's speculative pieces against the JAX package's, on the CPU:
the accept rules (linear and tree), the n-gram drafter (chains and trees),
and the decode model's verify, tree verify and fused mixed-mode steps.

The accept rule and the drafter are integer logic: they must agree
exactly. The two steps run the tiny config in fp32 with the same weights;
their integer outputs (emitted tokens, accept lengths, new resident
tokens and positions) must be equal, and the pool rows they write agree
within 1e-5 (summation order). Both steps run on the paged kernel's path
(JAX's Pallas kernel in interpret mode, the port's plain version) and on
the gather path. The tree steps also commit their accepted path's rows
to the frontier: the pool after the commit agrees as the written rows do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.inference.model import (
    LlamaDecode as JaxLlamaDecode,
)
from neuronx_distributed_llama3_2_tpu.inference.speculative import (
    accept_rule as jax_accept_rule,
    tree_accept_rule as jax_tree_accept_rule,
    tree_topology as jax_tree_topology,
)
from neuronx_distributed_llama3_2_tpu.models.llama import (
    LLAMA_CONFIGS as JAX_CONFIGS,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_llama3_2_tpu.serving.drafter import (
    NGramDrafter as JaxNGramDrafter,
    TreeDrafter as JaxTreeDrafter,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.model import LlamaDecode
from neuronx_distributed_llama3_2_tpu_torch.inference.speculative import (
    accept_rule,
    tree_accept_rule,
    tree_topology,
)
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    LlamaForCausalLM,
    params_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.drafter import (
    DraftProposer,
    NGramDrafter,
    TreeDrafter,
)

torch.set_num_threads(1)


# -- accept_rule ------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4, 7])
def test_accept_rule_matches_jax(k):
    """Random drafts, targets and draft caps over a small alphabet (so
    that long agreeing prefixes occur): accept and the whole emitted row
    equal JAX's, with and without a cap."""
    rng = np.random.default_rng(k)
    drafts = rng.integers(0, 3, size=(256, k)).astype(np.int32)
    greedy = rng.integers(0, 3, size=(256, k + 1)).astype(np.int32)
    greedy[:64, :k] = drafts[:64]  # full agreement on a quarter
    dlen = rng.integers(0, k + 1, size=(256,)).astype(np.int32)
    for cap in (dlen, None):
        ja, je = jax_accept_rule(drafts, greedy, draft_len=cap)
        ta, te = accept_rule(
            torch.as_tensor(drafts), torch.as_tensor(greedy),
            draft_len=None if cap is None else torch.as_tensor(cap),
        )
        assert ta.dtype == te.dtype == torch.int32
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        assert (ta.numpy() == k).any() and (ta.numpy() == 0).any()


# -- the n-gram drafter -------------------------------------------------------------


@pytest.mark.parametrize("history,max_tokens,max_n,min_n,want", [
    # the last 3-gram (4, 5, 6) occurred earlier, followed by 7, 8
    ([1, 4, 5, 6, 7, 8, 2, 4, 5, 6], 2, 3, 1, [7, 8]),
    # the longest n wins: the 2-gram (2, 3) -> 4 before the 1-gram -> 9
    ([2, 3, 4, 1, 3, 9, 2, 3], 1, 3, 1, [4]),
    ([1, 2, 3, 4, 5], 4, 3, 2, []),          # no repeated 2/3-gram
    ([1, 2], 4, 3, 2, []),                    # history too short
    ([1, 2, 1, 2], 0, 3, 2, []),              # no budget
    ([1, 2, 5, 1, 2, 9, 3, 1, 2], 1, 2, 2, [9]),  # the latest occurrence
])
def test_ngram_drafter_cases_match_jax(history, max_tokens, max_n, min_n, want):
    port = NGramDrafter(max_n=max_n, min_n=min_n)
    ref = JaxNGramDrafter(max_n=max_n, min_n=min_n)
    assert port.propose(history, max_tokens) == ref.propose(history, max_tokens) == want
    assert isinstance(port, DraftProposer)


def test_ngram_drafter_random_histories_match_jax():
    rng = np.random.default_rng(0)
    for i in range(300):
        n = int(rng.integers(0, 40))
        history = rng.integers(0, 1 + i % 6, size=n).tolist()
        max_n = int(rng.integers(1, 5))
        min_n = int(rng.integers(1, max_n + 1))
        budget = int(rng.integers(0, 6))
        want = JaxNGramDrafter(max_n, min_n).propose(history, budget)
        assert NGramDrafter(max_n, min_n).propose(history, budget) == want
    with pytest.raises(ValueError, match="min_n <= max_n"):
        NGramDrafter(max_n=1, min_n=2)


# -- the verify and mixed steps ------------------------------------------------------

JAX_TINY = JAX_CONFIGS["tiny"]
TINY = LLAMA_CONFIGS["tiny"]
NB, BS, W = 24, 8, 10


@pytest.fixture(scope="module")
def weights():
    jp = JaxLlama(JAX_TINY).init(jax.random.key(2))
    model = LlamaForCausalLM(TINY, device="cpu")
    model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, jp), TINY, device="cpu")
    )
    return jp, model


def _decoders(kernel: bool):
    cfg = dict(use_paged_kernel=kernel)
    return (
        JaxLlamaDecode(dataclasses.replace(JAX_TINY, **cfg)),
        LlamaDecode(dataclasses.replace(TINY, **cfg)),
    )


def _prefilled(weights, kernel, tables, prompt):
    """Both decoders with a fresh pool each, after one whole-prompt
    prefill of ``prompt`` (b, P) over ``tables``."""
    jp, model = weights
    jdec, tdec = _decoders(kernel)
    jcache = jdec.init_paged_cache(NB, BS)
    tcache = tdec.init_paged_cache(NB, BS, device="cpu")
    b = prompt.shape[0]
    _, jcache = jdec.forward(
        jp, jcache, jnp.asarray(prompt, jnp.int32), jnp.zeros((b,), jnp.int32),
        block_tables=jnp.asarray(tables), context_encode=True,
    )
    tdec.forward(
        model, tcache, torch.as_tensor(prompt), torch.zeros((b,), dtype=torch.int32),
        block_tables=torch.as_tensor(tables), context_encode=True,
    )
    return jdec, tdec, jcache, tcache


def _greedy_chain(weights, tables, prompt, cur, pos, k):
    """A draft the target accepts in full: k plain decode steps of the
    port from (cur, pos) on a scratch pool. Returns (b, k) drafts."""
    _, model = weights
    _, tdec, _, cache = _prefilled(weights, False, tables, prompt)
    tok = torch.as_tensor(cur, dtype=torch.int32)
    p = torch.as_tensor(pos, dtype=torch.int32)
    t = torch.as_tensor(tables)
    out = []
    for _ in range(k):
        logits, p, cache = tdec.decode_step(model, cache, tok, p, t)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1).numpy()


def _assert_same_outputs(j_out, t_out, jcache, tcache, blocks):
    for jx, tx in zip(j_out[:4], t_out[:4]):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    for pool in ("k", "v"):
        np.testing.assert_allclose(
            getattr(tcache, pool)[:, blocks].numpy(),
            np.asarray(getattr(jcache, pool)[:, blocks]), atol=1e-5,
        )


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "gather"])
def test_verify_step_matches_jax(weights, kernel):
    """Three lanes verify k = 4 drafts after a 13-token prefill: lane 0 a
    greedy chain (accepted in full, the bonus token emitted), lane 1 the
    same chain with draft_len 2, lane 2 random drafts. Emitted, accept,
    new tokens and positions equal JAX's; the rows written agree."""
    jp, model = weights
    k, plen = 4, 13
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, TINY.vocab_size, size=(3, plen))
    tables = np.zeros((3, W), np.int32)
    tables[:, :3] = [[3, 5, 7], [2, 9, 4], [11, 6, 8]]
    cur = rng.integers(0, TINY.vocab_size, size=(3,))
    chain = _greedy_chain(weights, tables, prompt, cur, [plen] * 3, k)
    drafts = chain.copy()
    drafts[2] = rng.integers(0, TINY.vocab_size, size=(k,))
    tokens = np.concatenate([cur[:, None], drafts], axis=1)
    draft_len = np.asarray([k, 2, k], np.int32)
    pos = np.full((3,), plen, np.int32)
    jdec, tdec, jcache, tcache = _prefilled(weights, kernel, tables, prompt)
    j_out = jdec.verify_step(
        jp, jcache, jnp.asarray(tokens, jnp.int32), jnp.asarray(pos),
        jnp.asarray(tables), jnp.asarray(draft_len), kv_limit=32, pos_cap=63,
    )
    t_out = tdec.verify_step(
        model, tcache, torch.as_tensor(tokens, dtype=torch.int32), torch.as_tensor(pos),
        torch.as_tensor(tables), torch.as_tensor(draft_len), kv_limit=32, pos_cap=63,
    )
    _assert_same_outputs(j_out, t_out, j_out[-1], t_out[-1], [2, 3, 4, 5, 6, 7, 8, 9, 11])
    assert t_out[1].tolist() == [k, 2, 0]
    assert t_out[3].tolist() == [plen + k + 1, plen + 3, plen + 1]
    path = "kernel" if kernel else "gather"
    assert tdec.attention_paths[path] == TINY.num_layers


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "gather"])
def test_mixed_step_matches_jax(weights, kernel):
    """One t = 6 mixed block over four lanes: lane 0 a forced prefill
    chunk of 5 rows at row 8 of its own prompt (row_live 5), lane 1 a
    verify of 3 greedy drafts (row_live 4), lane 2 a plain decode (row_live
    1), lane 3 idle on an all-null table. Every output of the step equals
    JAX's, the whole emitted rows included (padding rows too: the port's
    kernel path gives them the TPU kernel's walk)."""
    jp, model = weights
    t, plen = 6, 13
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, TINY.vocab_size, size=(4, plen))
    tables = np.zeros((4, W), np.int32)
    tables[:3, :3] = [[3, 5, 7], [2, 9, 4], [11, 6, 8]]
    cur = rng.integers(0, TINY.vocab_size, size=(4,)).astype(np.int32)
    chain = _greedy_chain(weights, tables, prompt, cur, [plen] * 4, 3)
    rows = np.zeros((4, t), np.int32)
    rows[0, :5] = prompt[0, 8:13]
    rows[1, :3] = chain[1]
    row_start = np.asarray([8, 0, 0, 0], np.int32)
    row_len = np.asarray([5, 3, 0, 0], np.int32)
    forced = np.asarray([1, 0, 0, 0], np.int32)
    pos = np.asarray([13, plen, plen, 0], np.int32)
    jdec, tdec, jcache, tcache = _prefilled(weights, kernel, tables, prompt)
    args = (cur, pos, tables, rows, row_start, row_len, forced)
    j_out = jdec.mixed_step(
        jp, jcache, *(jnp.asarray(a) for a in args), kv_limit=32, pos_cap=79,
    )
    t_out = tdec.mixed_step(
        model, tcache, *(torch.as_tensor(a) for a in args), kv_limit=32, pos_cap=79,
    )
    _assert_same_outputs(j_out, t_out, j_out[-1], t_out[-1], [2, 3, 4, 5, 6, 7, 8, 9, 11])
    assert t_out[1].tolist() == [4, 3, 0, 0]
    assert t_out[3].tolist() == [13, plen + 4, plen + 1, 1]
    # the forced lane's emitted token at its last chunk row is the target
    # for row 13: what a plain decode of the whole prompt would sample
    assert int(t_out[2][0]) == int(_greedy_chain(
        weights, tables, prompt[:, :12], prompt[:, 12], [12] * 4, 1)[0, 0])


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "gather"])
def test_verify_beside_a_lane_idle_at_pos_cap_stays_finite(weights, kernel):
    """Lane 0 idles on an all-null table at pos_cap, the table's last row,
    so a k = 4 verify writes its rows 80..83 past the table and the rope
    table: into the null block. Lane 1 verifies one draft (the others
    trimmed for want of a block) at row 14, so its walk reads its
    null-backed frontier block, those rows included, at weight 0. Lane
    1's logits stay finite and equal (within 1e-6) those of the same step
    beside lane 0 idle at row 0, and so do its outputs. (The JAX package
    fills NaN past its rope table and gives NaN here; the port fills 0.)"""
    _, model = weights
    k, plen = 4, 14
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, TINY.vocab_size, size=(2, plen))
    tables = np.zeros((2, W), np.int32)
    tables[1, :2] = [3, 5]
    tokens = torch.as_tensor(rng.integers(0, TINY.vocab_size, size=(2, k + 1)),
                             dtype=torch.int32)
    draft_len = torch.as_tensor([0, 1], dtype=torch.int32)
    pos_cap = W * BS - 1
    runs = []
    for idle_pos in (pos_cap, 0):
        pos = torch.as_tensor([idle_pos, plen], dtype=torch.int32)
        _, tdec, _, tcache = _prefilled(weights, kernel, tables, prompt)
        logits, _ = tdec.forward(
            model, tcache, tokens, pos, None, block_tables=torch.as_tensor(tables),
            kv_limit=32,
        )
        _, tdec, _, tcache = _prefilled(weights, kernel, tables, prompt)
        out = tdec.verify_step(
            model, tcache, tokens, pos, torch.as_tensor(tables), draft_len,
            kv_limit=32, pos_cap=pos_cap,
        )
        assert bool(torch.isfinite(logits[1, :2]).all())
        runs.append((logits[1, :2], [x[1].tolist() for x in out[:4]]))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=1e-6)
    assert runs[0][1] == runs[1][1]


def test_steps_raise_on_unported_arguments(weights):
    """No step argument of the JAX package is left unported: each step
    takes the JAX step's keyword arguments, ``logit_poison`` (the
    finite-logit check) the last of them, and returns one ``finite`` bool
    a lane with it, False where the poison mask is set."""
    import inspect

    from neuronx_distributed_llama3_2_tpu.inference.model import LlamaDecode as JaxDecode

    for name in ("decode_step", "verify_step", "mixed_step", "tree_verify_step"):
        def kwonly(fn):
            return {p.name for p in inspect.signature(fn).parameters.values()
                    if p.kind is inspect.Parameter.KEYWORD_ONLY}
        assert kwonly(getattr(JaxDecode, name)) <= kwonly(getattr(LlamaDecode, name)), name
    _, model = weights
    dec = LlamaDecode(TINY)
    cache = dec.init_paged_cache(4, 8, device="cpu")
    z = torch.zeros((2,), dtype=torch.int32)
    poison = torch.tensor([0, 1], dtype=torch.int32)
    tables = torch.zeros((2, 4), dtype=torch.int32)
    rows = torch.zeros((2, 3), dtype=torch.int32)
    outs = (
        dec.decode_step(model, cache, z, z, tables, logit_poison=poison),
        dec.verify_step(model, cache, rows, z, tables, z, logit_poison=poison),
        dec.mixed_step(model, cache, z, z, tables, rows, z, z, z, logit_poison=poison),
        dec.tree_verify_step(model, cache, rows, z, tables, rows, z, logit_poison=poison),
    )
    for out in outs:
        finite = out[1] if len(out) == 4 else out[4]
        assert finite.dtype == torch.bool and finite.tolist() == [True, False]



# -- tree speculation: topology, accept rule, drafter ----------------------------


def _packed_parents(rng, b, t, lo=-2):
    """Random parent pointers, out-of-range values among them (both
    packages clip them into [0, j - 1])."""
    return rng.integers(lo, t + 2, size=(b, t)).astype(np.int32)


@pytest.mark.parametrize("t", [1, 2, 5, 32])
def test_tree_topology_and_accept_rule_match_jax(t):
    """Random packed trees over a 3-token alphabet (long accepted paths and
    equal-depth ties occur), with and without a node_len cap, 0 and past-t
    caps among them: depths, ancestors, accept, emitted (whole rows) and
    best equal JAX's."""
    rng = np.random.default_rng(40 + t)
    b = 256
    parents = _packed_parents(rng, b, t)
    tokens = rng.integers(0, 3, size=(b, t)).astype(np.int32)
    targets = rng.integers(0, 3, size=(b, t)).astype(np.int32)
    node_len = rng.integers(0, t + 2, size=(b,)).astype(np.int32)
    # jitted: JAX's Python loops over the nodes are slow eagerly
    jd, ja = jax.jit(jax_tree_topology)(parents)
    td, ta = tree_topology(torch.as_tensor(parents))
    assert td.dtype == torch.int32 and ta.dtype == torch.bool
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    jax_rule = jax.jit(jax_tree_accept_rule)
    for cap in (node_len, None):
        want = jax_rule(tokens, targets, parents, node_len=cap)
        got = tree_accept_rule(
            torch.as_tensor(tokens), torch.as_tensor(targets), torch.as_tensor(parents),
            node_len=None if cap is None else torch.as_tensor(cap),
        )
        for w, g in zip(want, got):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))



def test_tree_accept_ties_break_to_the_lowest_node():
    """Two accepted nodes at the deepest accepted depth: best is the lower
    index, in both packages; node_len 2 leaves only the first live."""
    tokens = np.asarray([[9, 4, 4, 5, 4]], np.int32)
    parents = np.asarray([[0, 0, 0, 1, 2]], np.int32)
    targets = np.asarray([[4, 6, 6, 0, 0]], np.int32)  # nodes 1 and 2 accepted
    for cap, want in ((None, (1, 1)), (np.asarray([2], np.int32), (1, 1)),
                      (np.asarray([1], np.int32), (0, 0))):
        ja, je, jb = jax_tree_accept_rule(tokens, targets, parents, node_len=cap)
        ta, te, tb = tree_accept_rule(
            *(torch.as_tensor(x) for x in (tokens, targets, parents)),
            node_len=None if cap is None else torch.as_tensor(cap),
        )
        assert (int(ta[0]), int(tb[0])) == (int(ja[0]), int(jb[0])) == want
        assert te.tolist() == np.asarray(je).tolist()
    tokens[0, 4] = 6  # node 4 (under node 2) now accepted one deeper
    _, _, tb = tree_accept_rule(*(torch.as_tensor(x) for x in (tokens, targets, parents)))
    assert int(tb[0]) == 4


def test_chain_tree_accept_is_the_linear_accept_rule():
    """On a chain (parents[j] = j - 1) the tree rule is accept_rule:
    accept and the emitted tokens up to accept + 1 agree, best == accept."""
    rng = np.random.default_rng(8)
    k = 6
    drafts = rng.integers(0, 2, size=(512, k)).astype(np.int32)
    greedy = rng.integers(0, 2, size=(512, k + 1)).astype(np.int32)
    dlen = rng.integers(0, k + 1, size=(512,)).astype(np.int32)
    tokens = np.concatenate([rng.integers(0, 2, size=(512, 1)), drafts], 1).astype(np.int32)
    chain = np.broadcast_to(np.maximum(np.arange(k + 1) - 1, 0), (512, k + 1)).copy()
    la, le = accept_rule(torch.as_tensor(drafts), torch.as_tensor(greedy),
                         draft_len=torch.as_tensor(dlen))
    ta, te, tb = tree_accept_rule(torch.as_tensor(tokens), torch.as_tensor(greedy),
                                  torch.as_tensor(chain), node_len=torch.as_tensor(dlen + 1))
    assert torch.equal(ta, la) and torch.equal(tb, la)
    for i in range(512):
        a = int(la[i])
        assert te[i, : a + 1].tolist() == le[i, : a + 1].tolist()
    assert (la.numpy() == k).any() and (la.numpy() == 0).any()


@pytest.mark.parametrize("history,max_nodes,branches", [
    ([3, 1] + [5] * 7, 4, 2),                        # the run tail deepens the chain
    ([1, 4, 5, 6, 7, 8, 2, 4, 5, 6], 4, 2),          # the propose chain leftmost
    ([1, 4, 5, 6, 7, 8, 2, 4, 5, 6], 4, 1),          # one branch: the chain
    ([1, 2, 5, 7, 1, 2, 9, 3, 1, 2], 6, 2),          # divergent sites branch
    ([1, 2, 3], 0, 2),                               # no budget
    ([1, 2, 5, 7, 1, 2, 9, 3, 1, 2, 8, 1, 2], 3, 3),  # budget cuts the third site
])
def test_propose_tree_matches_jax(history, max_nodes, branches):
    """The JAX package's own drafter cases (tests/test_speculative_serving.py),
    tokens and parents equal."""
    port = NGramDrafter(max_n=3, min_n=1).propose_tree(history, max_nodes, branches)
    ref = JaxNGramDrafter(max_n=3, min_n=1).propose_tree(history, max_nodes, branches)
    assert port == ref
    toks, pars = port
    for i, p in enumerate(pars):
        assert 0 <= p <= i
    if branches == 1:
        assert toks == NGramDrafter(3, 1).propose(history, max_nodes)


def test_propose_tree_random_histories_match_jax():
    rng = np.random.default_rng(1)
    branched = 0
    for i in range(400):
        history = rng.integers(0, 1 + i % 6, size=int(rng.integers(0, 40))).tolist()
        max_n = int(rng.integers(1, 5))
        min_n = int(rng.integers(1, max_n + 1))
        nodes, branches = int(rng.integers(0, 9)), int(rng.integers(1, 4))
        want = JaxNGramDrafter(max_n, min_n).propose_tree(history, nodes, branches)
        got = NGramDrafter(max_n, min_n).propose_tree(history, nodes, branches)
        assert got == want
        branched += got[1] != list(range(len(got[1])))
    assert branched > 0


def test_tree_drafter_adapter_matches_jax():
    class _Chain:
        def propose(self, history, max_tokens):
            return [7, 8, 9][:max_tokens]

    for cls in (TreeDrafter, JaxTreeDrafter):
        td = cls(_Chain(), branches=3)
        assert td.propose([1, 2], 2) == [7, 8]
        assert td.propose_tree([1, 2], 3) == ([7, 8, 9], [0, 1, 2])
    run = [3, 1] + [5] * 7
    assert (TreeDrafter(NGramDrafter(3, 1), branches=2).propose_tree(run, 4)
            == JaxTreeDrafter(JaxNGramDrafter(3, 1), branches=2).propose_tree(run, 4)
            == NGramDrafter(3, 1).propose_tree(run, 4, 2))
    assert isinstance(TreeDrafter(_Chain()), DraftProposer)
    with pytest.raises(ValueError, match="branches"):
        TreeDrafter(_Chain(), branches=0)


# -- the tree verify and mixed steps ----------------------------------------------


def _decoy_tree(chain_row, vocab, k):
    """Node tokens and parents of a tree whose first branch is a decoy (a
    token the greedy stream does not take next) and whose second carries
    the greedy continuation ``chain_row``: nodes [cur, decoy, g0, g1, ...]
    with parents [0, 0, 0, 2, 3, ...]. Accepting the greedy path runs
    through node indices one past their depths, so the commit moves rows."""
    decoy = (int(chain_row[0]) + 1) % vocab
    nodes = [decoy] + [int(x) for x in chain_row[: k - 1]]
    parents = [0, 0, 0] + list(range(2, k))
    return nodes, parents[: k + 1]


def _tree_case(weights, k, plen, seed, lanes=3):
    """Three lanes after a plen-token prefill: lane 0 the decoy tree over the
    greedy chain (accepted through the second branch), lane 1 a random
    branching tree with node_len k - 1, lane 2 a chain of the greedy
    tokens. Returns (prompt, tables, cur, tokens (b, k+1), parents,
    node_len)."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, TINY.vocab_size, size=(lanes, plen))
    tables = np.zeros((lanes, W), np.int32)
    tables[:, :3] = [[3, 5, 7], [2, 9, 4], [11, 6, 8]][:lanes]
    cur = rng.integers(0, TINY.vocab_size, size=(lanes,)).astype(np.int32)
    chain = _greedy_chain(weights, tables, prompt, cur, [plen] * lanes, k)
    tokens = np.zeros((lanes, k + 1), np.int32)
    parents = np.zeros((lanes, k + 1), np.int32)
    tokens[:, 0] = cur
    nodes, pars = _decoy_tree(chain[0], TINY.vocab_size, k)
    tokens[0, 1:], parents[0] = nodes, pars
    tokens[1, 1:] = rng.integers(0, TINY.vocab_size, size=(k,))
    tokens[1, 1] = chain[1, 0]  # accepted: node 1 is the greedy next token
    for j in range(1, k + 1):
        parents[1, j] = rng.integers(0, j)
    tokens[2, 1:] = chain[2]
    parents[2] = np.maximum(np.arange(k + 1) - 1, 0)
    node_len = np.asarray([k + 1, k - 1, k + 1], np.int32)[:lanes]
    return prompt, tables, cur, tokens, parents, node_len


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "gather"])
def test_tree_forward_matches_jax(weights, kernel):
    """forward(tree=) over a branching tree per lane: logits within 2e-5 of
    JAX's (fp32, summation order), the rows written (node j at position +
    j, roped at its depth) agree, and the path taken is the one asked
    for."""
    jp, model = weights
    k, plen = 5, 13
    prompt, tables, _, tokens, parents, _ = _tree_case(weights, k, plen, 9)
    pos = np.full((3,), plen, np.int32)
    jdec, tdec, jcache, tcache = _prefilled(weights, kernel, tables, prompt)
    jtopo = jax_tree_topology(parents)
    jl, jcache = jdec.forward(
        jp, jcache, jnp.asarray(tokens), jnp.asarray(pos), block_tables=jnp.asarray(tables),
        kv_limit=32, tree=jtopo,
    )
    tl, tcache = tdec.forward(
        model, tcache, torch.as_tensor(tokens), torch.as_tensor(pos),
        block_tables=torch.as_tensor(tables), kv_limit=32,
        tree=tree_topology(torch.as_tensor(parents)),
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)
    _assert_same_outputs([], [], jcache, tcache, [2, 3, 4, 5, 6, 7, 8, 9, 11])
    assert tdec.attention_paths["kernel" if kernel else "gather"] == TINY.num_layers
    with pytest.raises(ValueError, match="ancestor mask"):
        tdec.forward(model, tcache, torch.as_tensor(tokens), torch.as_tensor(pos),
                     block_tables=torch.as_tensor(tables), context_encode=True,
                     tree=tree_topology(torch.as_tensor(parents)))


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "gather"])
def test_tree_verify_step_matches_jax(weights, kernel):
    """tree_verify_step on _tree_case: emitted, accept, new tokens and
    positions equal JAX's; the decoy lane accepts its whole greedy branch
    through node indices past their depths, so its commit moves rows; the
    pool after the commit agrees with JAX's, and the committed rows hold
    what a linear verify of the greedy chain writes there (without the
    commit the decoy's K/V would sit at the first of them)."""
    jp, model = weights
    k, plen = 5, 13
    prompt, tables, cur, tokens, parents, node_len = _tree_case(weights, k, plen, 9)
    pos = np.full((3,), plen, np.int32)
    jdec, tdec, jcache, tcache = _prefilled(weights, kernel, tables, prompt)
    args = (tokens, pos, tables, parents, node_len)
    j_out = jdec.tree_verify_step(jp, jcache, *(jnp.asarray(a) for a in args),
                                  kv_limit=32, pos_cap=79)
    t_out = tdec.tree_verify_step(model, tcache, *(torch.as_tensor(a) for a in args),
                                  kv_limit=32, pos_cap=79)
    blocks = [2, 3, 4, 5, 6, 7, 8, 9, 11]
    _assert_same_outputs(j_out, t_out, j_out[-1], t_out[-1], blocks)
    assert t_out[1].tolist()[0] == k - 1 and t_out[1].tolist()[2] == k
    assert int(t_out[1][1]) >= 1
    # the committed rows are the linear verify's rows of the same chain
    _, ldec, _, lcache = _prefilled(weights, kernel, tables, prompt)
    chain = np.concatenate([cur[:, None], np.stack([tokens[0, 2:], tokens[0, 2:],
                                                    tokens[0, 2:]])], 1)
    ldec.verify_step(model, lcache, torch.as_tensor(chain, dtype=torch.int32),
                     torch.as_tensor(pos), torch.as_tensor(tables),
                     torch.as_tensor([k - 1] * 3, dtype=torch.int32), kv_limit=32)
    rows = [plen + d for d in range(k)]  # cur and the k - 1 accepted nodes
    phys = [tables[0, r // BS] * BS + r % BS for r in rows]
    for pool in ("k", "v"):
        got = getattr(t_out[-1], pool).flatten(1, 2)[:, phys]
        want = getattr(lcache, pool).flatten(1, 2)[:, phys]
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "gather"])
def test_tree_mixed_step_matches_jax(weights, kernel):
    """mixed_step(parents=) at t = 6: lane 0 a forced chunk (its parents
    ignored: steered onto the chain), lane 1 the decoy tree, lane 2 a
    branching tree of 3 nodes over a t = 6 grid (row_live 4), lane 3 a
    plain decode. Every output equals JAX's, the pool after the commit
    agrees, and the forced lane's emitted row is its raw targets as on the
    linear path."""
    jp, model = weights
    t, plen = 6, 13
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, TINY.vocab_size, size=(4, plen))
    tables = np.zeros((4, W), np.int32)
    tables[:, :3] = [[3, 5, 7], [2, 9, 4], [11, 6, 8], [10, 12, 13]]
    cur = rng.integers(0, TINY.vocab_size, size=(4,)).astype(np.int32)
    chain = _greedy_chain(weights, tables, prompt, cur, [plen] * 4, t - 1)
    rows = np.zeros((4, t), np.int32)
    parents = rng.integers(0, t, size=(4, t)).astype(np.int32)  # garbage on lane 0
    rows[0, :5] = prompt[0, 8:13]
    nodes, pars = _decoy_tree(chain[1], TINY.vocab_size, t - 1)
    rows[1, : t - 1], parents[1] = nodes, pars
    rows[2, :3] = [chain[2, 0], 7, chain[2, 1]]
    parents[2, :4] = [0, 0, 0, 1]
    parents[3] = 0
    row_start = np.asarray([8, 0, 0, 0], np.int32)
    row_len = np.asarray([5, t - 1, 3, 0], np.int32)
    forced = np.asarray([1, 0, 0, 0], np.int32)
    pos = np.asarray([13, plen, plen, plen], np.int32)
    jdec, tdec, jcache, tcache = _prefilled(weights, kernel, tables, prompt)
    args = (cur, pos, tables, rows, row_start, row_len, forced)
    j_out = jdec.mixed_step(jp, jcache, *(jnp.asarray(a) for a in args), kv_limit=32,
                            pos_cap=79, parents=jnp.asarray(parents))
    t_out = tdec.mixed_step(model, tcache, *(torch.as_tensor(a) for a in args), kv_limit=32,
                            pos_cap=79, parents=torch.as_tensor(parents))
    _assert_same_outputs(j_out, t_out, j_out[-1], t_out[-1],
                         [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13])
    assert t_out[1].tolist()[:2] == [4, t - 2]
    # the forced lane reads as on the linear path
    _, ldec, _, lcache = _prefilled(weights, kernel, tables, prompt)
    lin = ldec.mixed_step(model, lcache, *(torch.as_tensor(a) for a in args),
                          kv_limit=32, pos_cap=79)
    assert lin[0][0].tolist() == t_out[0][0].tolist()
    assert int(lin[2][0]) == int(t_out[2][0]) and int(lin[3][0]) == int(t_out[3][0])
