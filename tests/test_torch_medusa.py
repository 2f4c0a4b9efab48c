"""The port's Medusa decoding against the JAX package's, on the CPU.

Mirrors ``tests/test_medusa.py``'s six cases: the static tree buffers
(equal to JAX's), the rank check, the hard invariant (Medusa's greedy
output is the plain greedy decode), oracle candidates that are accepted,
the committed cache rows against sequential decode, and the tree
forward against the sequential one. The decoders run the tiny config in
fp32 with the JAX package's weights and heads (``params_from_jax``,
``medusa_params_from_jax``), the decoder layers scaled up so that the
greedy streams do not repeat one token; tokens and per-round accept counts
must equal the JAX decoder's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.inference.engine import (
    GenerationConfig as JaxGen,
    InferenceEngine as JaxEngine,
)
from neuronx_distributed_llama3_2_tpu.inference.medusa import (
    MedusaDecoder as JaxMedusaDecoder,
    MedusaHeads as JaxMedusaHeads,
    generate_medusa_buffers as jax_buffers,
)
from neuronx_distributed_llama3_2_tpu.models.llama import (
    LLAMA_CONFIGS as JAX_CONFIGS,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
    GenerationConfig,
    InferenceEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.medusa import (
    DEFAULT_MEDUSA_CHOICES,
    MedusaDecoder,
    MedusaHeads,
    generate_medusa_buffers,
    medusa_params_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    LlamaForCausalLM,
    params_from_jax,
)
from tests.test_torch_async import _scaled

torch.set_num_threads(1)

JAX_TINY = JAX_CONFIGS["tiny"]
TINY = LLAMA_CONFIGS["tiny"]
KW = dict(max_batch=2, max_seq_len=128)


# -- buffers -------------------------------------------------------------------------


def test_buffers_structure():
    b = generate_medusa_buffers([(0,), (1,), (0, 0)], topk=4)
    assert b.tree_len == 4
    assert b.depths.tolist() == [0, 1, 1, 2]
    assert b.tree_indices.tolist() == [0, 1, 2, 5]
    assert b.ancestor_mask[3].tolist() == [True, True, False, True]
    assert b.retrieve_indices.tolist() == [[0, 1, -1], [0, 2, -1], [0, 1, 3]]
    for choices, topk in (([(0,), (1,), (0, 0)], 4), (DEFAULT_MEDUSA_CHOICES, 10)):
        mine, want = generate_medusa_buffers(choices, topk), jax_buffers(choices, topk)
        for f in ("tree_indices", "depths", "ancestor_mask", "retrieve_indices"):
            np.testing.assert_array_equal(getattr(mine, f), getattr(want, f))
        np.testing.assert_array_equal(mine.packed_parents(), want.packed_parents())


def test_buffers_reject_rank_beyond_topk():
    with pytest.raises(ValueError):
        generate_medusa_buffers([(5,)], topk=4)


# -- end-to-end greedy equivalence ----------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same scaled weights."""
    jp = jax.tree_util.tree_map_with_path(
        _scaled, JaxLlama(JAX_TINY).init(jax.random.key(0))
    )
    model = LlamaForCausalLM(TINY, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), TINY, device="cpu"))
    return JaxEngine(JAX_TINY, jp, **KW), InferenceEngine(TINY, model, **KW)


def _heads(seed):
    """(JAX heads params, port MedusaHeads) of the same seeded weights."""
    mp = JaxMedusaHeads(TINY.hidden_size, TINY.vocab_size, num_heads=3).init(
        jax.random.key(seed))
    port = medusa_params_from_jax(jax.tree.map(np.asarray, mp), TINY.hidden_size,
                                  TINY.vocab_size, device="cpu")
    return mp, port


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, TINY.vocab_size, n).tolist()


def test_medusa_matches_plain_greedy(engines):
    """Medusa tree decode emits the plain greedy continuation, and the JAX
    decoder's tokens round by round."""
    je, te = engines
    prompt = _prompt(0, 9)
    ref = te.generate([prompt], GenerationConfig(max_new_tokens=24)).sequences[0]
    assert ref == list(map(int, je.generate([prompt], JaxGen(max_new_tokens=24)).sequences[0]))
    mp, heads = _heads(7)
    out = MedusaDecoder(te, heads, num_heads=3).generate(prompt, max_new_tokens=24)
    assert out.tokens == ref, (out.tokens, ref)
    jout = JaxMedusaDecoder(je, mp, num_heads=3).generate(prompt, max_new_tokens=24)
    assert out.tokens == list(map(int, jout.tokens))
    assert out.accepted_per_round == jout.accepted_per_round
    assert len(out.accepted_per_round) >= 1


def _oracle(base_cls, ref):
    class Oracle(base_cls):
        """Injects the true greedy continuation as the chain-path
        candidates, so rounds accept tokens."""

        def _candidates(self, base_token, topk_ids):
            flat = super()._candidates(base_token, topk_ids)
            try:
                i = ref.index(base_token)
            except ValueError:
                return flat
            bufs = self.buffers
            chain = ref[i + 1: i + 1 + int(bufs.depths.max())]
            for d, tok in enumerate(chain, start=1):
                slot = [s for s in range(bufs.tree_len)
                        if bufs.depths[s] == d and bufs.tree_indices[s] == 1 + (d - 1) * bufs.topk]
                if slot:
                    flat[slot[0]] = tok
            return flat

    return Oracle


def test_medusa_oracle_candidates_accept_and_stay_greedy(engines):
    """Oracle chain candidates are accepted (rounds accept > 0 tokens) and
    the output is still the plain greedy stream: the test that catches
    frontier and cache off-by-ones that zero-acceptance runs hide. The
    accept counts are the JAX oracle's."""
    je, te = engines
    prompt = _prompt(1, 5)
    ref = te.generate([prompt], GenerationConfig(max_new_tokens=16)).sequences[0]
    mp, heads = _heads(3)
    out = _oracle(MedusaDecoder, ref)(te, heads, num_heads=3).generate(prompt, 16)
    assert out.tokens == ref, (out.tokens, ref)
    assert max(out.accepted_per_round) > 0, out.accepted_per_round
    jout = _oracle(JaxMedusaDecoder, ref)(je, mp, num_heads=3).generate(prompt, 16)
    assert out.accepted_per_round == jout.accepted_per_round


def test_medusa_cache_rows_match_plain_decode(engines):
    """After Medusa generation the committed K/V rows equal sequential
    single-token decode's for the same emitted sequence (a direct detector
    for a commit off by one)."""
    _, te = engines
    prompt = _prompt(4, 6)
    _, heads = _heads(9)
    dec = _oracle(MedusaDecoder, te.generate(
        [prompt], GenerationConfig(max_new_tokens=12)).sequences[0])(te, heads, num_heads=3)
    out = dec.generate(prompt, max_new_tokens=10)
    assert max(out.accepted_per_round) > 0
    med_k = te.cache.k.clone()
    full = prompt + out.tokens
    dec._prefill(prompt)
    for tok_pos in range(len(prompt), len(full) - 1):
        _, _, te.cache = dec._commit(
            te.params, te.cache, torch.as_tensor([[full[tok_pos]]]),
            torch.as_tensor([tok_pos], dtype=torch.int32),
        )
    n = len(full) - 1
    np.testing.assert_allclose(med_k[:, 0, :n].numpy(), te.cache.k[:, 0, :n].numpy(),
                               atol=2e-5, err_msg="medusa-committed rows diverge")


def test_tree_attention_matches_sequential(engines):
    """A chain tree (each node the child of the one before) forwards as the
    plain block-causal forward, and as the JAX decoder's tree forward."""
    je, te = engines
    prompt = _prompt(2, 7)
    bufs = generate_medusa_buffers([(0,), (0, 0), (0, 0, 0)], topk=2)
    mp, heads = _heads(5)
    dec = MedusaDecoder(te, heads, buffers=bufs)
    jdec = JaxMedusaDecoder(je, mp, buffers=jax_buffers([(0,), (0, 0), (0, 0, 0)], topk=2))
    base, _, _ = dec._prefill(prompt)
    jbase, _, _ = jdec._prefill(prompt)
    assert base == jbase
    chain = np.asarray([base, 11, 12, 13], np.int32)
    pos = torch.as_tensor([len(prompt)], dtype=torch.int32)
    tree = (torch.as_tensor(bufs.depths), torch.as_tensor(bufs.ancestor_mask))
    logits_tree, _, _ = dec._fwd_hidden(te.params, te.cache, torch.as_tensor(chain[None]), pos,
                                        tree=tree)
    logits_seq, _, _ = dec._fwd_hidden(te.params, te.cache, torch.as_tensor(chain[None]), pos)
    np.testing.assert_allclose(logits_tree.numpy(), logits_seq.numpy(), atol=2e-5, rtol=1e-5)
    jl, _, _ = jdec._fwd_hidden(
        je.params, je.cache, jnp.asarray(chain[None]), jnp.asarray([len(prompt)], jnp.int32),
        tree=(jnp.asarray(bufs.depths), jnp.asarray(bufs.ancestor_mask)))
    np.testing.assert_allclose(logits_tree.numpy(), np.asarray(jl), atol=1e-4)


def test_medusa_heads_match_jax():
    """The heads loaded from the JAX pytree give the JAX heads' logits, and
    their top-k ids."""
    mp, heads = _heads(11)
    h = np.random.default_rng(0).standard_normal((1, 3, TINY.hidden_size)).astype(np.float32)
    want = JaxMedusaHeads(TINY.hidden_size, TINY.vocab_size, num_heads=3)(mp, jnp.asarray(h))
    got = heads(torch.as_tensor(h))
    assert tuple(got.shape) == (3, 1, 3, TINY.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="medusa heads"):
        MedusaDecoder(None, heads, num_heads=4)
