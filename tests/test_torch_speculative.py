"""The port's speculative pieces against the JAX package's, on the CPU:
the accept rule, the n-gram drafter, and the decode model's verify and
fused mixed-mode steps.

The accept rule and the drafter are integer logic: they must agree
exactly. The two steps run the tiny config in fp32 with the same weights;
their integer outputs (emitted tokens, accept lengths, new resident
tokens and positions) must be equal, and the pool rows they write agree
within 1e-5 (summation order). Both steps run on the paged kernel's path
(JAX's Pallas kernel in interpret mode, the port's plain version) and on
the gather path.
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
)
from neuronx_distributed_llama3_2_tpu.models.llama import (
    LLAMA_CONFIGS as JAX_CONFIGS,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_llama3_2_tpu.serving.drafter import (
    NGramDrafter as JaxNGramDrafter,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.model import LlamaDecode
from neuronx_distributed_llama3_2_tpu_torch.inference.speculative import accept_rule
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    LlamaForCausalLM,
    params_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.drafter import (
    DraftProposer,
    NGramDrafter,
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
    _, model = weights
    dec = LlamaDecode(TINY)
    cache = dec.init_paged_cache(4, 8, device="cpu")
    z = torch.zeros((1,), dtype=torch.int32)
    tables = torch.zeros((1, 4), dtype=torch.int32)
    rows = torch.zeros((1, 3), dtype=torch.int32)
    for kw, match in (
        (dict(sampling=(z,)), "on-device sampling"),
        (dict(logit_poison=z), "finite-logit check"),
    ):
        with pytest.raises(NotImplementedError, match=match):
            dec.verify_step(model, cache, rows, z, tables, z, **kw)
    for kw, match in (
        (dict(sampling=(z,)), "on-device sampling"),
        (dict(logit_poison=z), "finite-logit check"),
        (dict(parents=rows), "tree speculation"),
    ):
        with pytest.raises(NotImplementedError, match=match):
            dec.mixed_step(model, cache, z, z, tables, rows, z, z, z, **kw)
    with pytest.raises(NotImplementedError, match="tree"):
        dec.forward(model, cache, rows, z, block_tables=tables, tree=(rows, rows))
