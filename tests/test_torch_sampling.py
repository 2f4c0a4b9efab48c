"""The port's on-device sampling (``PagedConfig.on_device_sampling``)
against the JAX package's, on the CPU.

The sampler (``inference/sampling.py``) reproduces JAX's threefry2x32 in
torch integer ops: key data, ``fold_in`` and the random bits must equal
JAX's bit for bit, and ``sample_lanes`` must draw JAX's tokens on the same
fp32 logits (the gumbel noise agrees to a few float ulps, which moves no
argmax on these inputs). The four decode-model steps with ``sampling=``
draw by JAX's landing indices, so their tokens, accept counts and
positions equal JAX's. The serving engine under ``on_device_sampling``
then gives the JAX engine's sampled streams and sampling counters token
for token (bf16 and int8 chunked pools, linear and tree speculation with
the fused step, prewarm records, the async loop, preempt-resume), and
holds the properties of JAX's ``tests/test_fused_sampling.py``.

The engines run the tiny config in fp32 with the decoder layers scaled up
(``tests/test_torch_async.py``'s ``LAYER_SCALE``): at the init scale
every stream repeats one token, which would hide a draw keyed one index
off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.inference import (
    GenerationConfig as JaxGenerationConfig,
    InferenceEngine as JaxInferenceEngine,
)
from neuronx_distributed_llama3_2_tpu.inference import sampling as jax_sampling
from neuronx_distributed_llama3_2_tpu.inference.model import (
    LlamaDecode as JaxLlamaDecode,
)
from neuronx_distributed_llama3_2_tpu.models.llama import (
    LLAMA_CONFIGS as JAX_CONFIGS,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_llama3_2_tpu.serving import (
    PagedConfig as JaxPagedConfig,
    PagedServingEngine as JaxPagedServingEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.inference import sampling
from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
    GenerationConfig,
    InferenceEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.model import LlamaDecode
from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import (
    GREEDY_TEMPERATURE,
    SamplingConfig,
)
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    LlamaForCausalLM,
    params_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import (
    PagedConfig,
    PagedServingEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.tracing import EngineTracer
from tests.test_torch_async import _scaled

torch.set_num_threads(1)

JAX_TINY = dataclasses.replace(JAX_CONFIGS["tiny"], use_paged_kernel=True)
TINY = dataclasses.replace(LLAMA_CONFIGS["tiny"], use_paged_kernel=True)
ENGINE_KW = dict(max_batch=4, max_seq_len=64, buckets=[8, 16, 32])
POOL = dict(block_size=8, num_blocks=64)
SAMPLED = dict(greedy=False, temperature=0.8, top_k=40, top_p=0.9)
#: per-lane (temperature, top_k, top_p) rows: the greedy sentinel, top_k
#: past any vocab here, top_p 1.0 (off), sharp and flat configs
LANE_ROWS = [
    (GREEDY_TEMPERATURE, 0, 1.0),
    (0.7, 0, 1.0),
    (1.3, 8, 1.0),
    (0.9, 0, 0.8),
    (1.1, 16, 0.9),
    (1.0, 1000000, 1.0),
    (0.5, 3, 0.5),
    (1.0, 1, 1.0),
]


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _torch_keys(keys):
    return torch.as_tensor(np.asarray(keys).astype(np.int64))


# -- the sampler --------------------------------------------------------------------


def test_threefry_keys_and_bits_match_jax():
    """lane_keys / fold_in key data and random_bits equal JAX's bit for
    bit, for random keys and indices up to 2**31 - 1 (the bounds among
    them), and chained folds too."""
    rng = np.random.default_rng(0)
    keys = _u32(rng, (64, 2))
    keys[0] = 0
    keys[1] = 2 ** 32 - 1
    idx = rng.integers(0, 2 ** 31 - 1, size=(64,)).astype(np.int32)
    idx[:3] = [0, 1, 2 ** 31 - 1]
    want = np.asarray(jax.random.key_data(
        jax_sampling.lane_keys(jnp.asarray(keys), jnp.asarray(idx))
    ))
    got = sampling.lane_keys(_torch_keys(keys), torch.as_tensor(idx))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    twice = sampling.fold_in(got, torch.as_tensor(idx[::-1].copy()))
    want2 = [
        np.asarray(jax.random.key_data(jax.random.fold_in(
            jax.random.wrap_key_data(jnp.asarray(want[i])), int(idx[::-1][i])
        ))) for i in range(8)
    ]
    np.testing.assert_array_equal(twice[:8].numpy(), np.stack(want2).astype(np.int64))
    bits = sampling.random_bits(_torch_keys(keys[:4]), 777)
    for i in range(4):
        jb = jax.random.bits(jax.random.wrap_key_data(jnp.asarray(keys[i])), (777,),
                             jnp.uint32)
        np.testing.assert_array_equal(bits[i].numpy(), np.asarray(jb).astype(np.int64))


def test_gumbel_matches_jax():
    """The gumbel noise equals JAX's within 4 float32 ulps of 16 (the
    largest value it can take): the bits and the uniform are exact, the
    two logs are the libraries' own."""
    keys = _u32(np.random.default_rng(1), (3, 2))
    got = sampling.gumbel(_torch_keys(keys), 5000)
    for i in range(3):
        want = jax.random.gumbel(jax.random.wrap_key_data(jnp.asarray(keys[i])), (5000,))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0,
                                   atol=4 * np.spacing(np.float32(16)))


def _lane_args(rows, seed):
    rng = np.random.default_rng(seed)
    b = len(rows)
    keys = _u32(rng, (b, 2))
    temps = np.asarray([r[0] for r in rows], np.float32)
    topks = np.asarray([r[1] for r in rows], np.int32)
    topps = np.asarray([r[2] for r in rows], np.float32)
    return keys, temps, topks, topps


def _both_sample_lanes(logits, keys, index, temps, topks, topps):
    want = np.asarray(jax.jit(jax_sampling.sample_lanes)(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(index), jnp.asarray(temps),
        jnp.asarray(topks), jnp.asarray(topps),
    ))
    got = sampling.sample_lanes(
        torch.as_tensor(logits), _torch_keys(keys), torch.as_tensor(index),
        torch.as_tensor(temps), torch.as_tensor(topks), torch.as_tensor(topps),
    )
    assert got.dtype == torch.int32 and tuple(got.shape) == logits.shape[:-1]
    return got.numpy(), want


@pytest.mark.parametrize("v,t", [(256, 1), (256, 4), (128256, 1), (128256, 2)],
                         ids=["V256-decode", "V256-verify", "V128256-decode",
                              "V128256-verify"])
def test_sample_lanes_matches_jax(v, t):
    """(B, V) and (B, T, V) fp32 logits over LANE_ROWS' mixed configs
    (4 lanes at the full Llama-3 vocab): the draws equal JAX's, the greedy
    sentinel lane's are the exact argmax, and the sampled lanes do not all
    draw the argmax (the check can fail)."""
    rows = LANE_ROWS if v <= 256 else LANE_ROWS[:4]
    b = len(rows)
    keys, temps, topks, topps = _lane_args(rows, v + t)
    rng = np.random.default_rng(v * t)
    shape = (b, v) if t == 1 else (b, t, v)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    pos = rng.integers(0, 5000, size=(b,)).astype(np.int32)
    index = pos if t == 1 else (pos[:, None] + np.arange(t)).astype(np.int32)
    got, want = _both_sample_lanes(logits, keys, index, temps, topks, topps)
    np.testing.assert_array_equal(got, want)
    argmax = logits.argmax(-1)
    np.testing.assert_array_equal(got[0], argmax[0])
    assert (got[1:] != argmax[1:]).any()


def test_sample_lanes_ties_at_the_thresholds_match_jax():
    """Ties at the k-th value survive the top-k filter (a value threshold),
    and ties with the top-p boundary token survive top-p (the cutoff is
    the smallest kept value): the filtered logits keep exactly the tied
    set, and over many landing indices the draws equal JAX's and reach
    every tied token. A greedy lane with tied maxima takes the first."""
    v = 32
    base = np.full((v,), -4.0, np.float32)
    base[[3, 9, 17]] = 2.0            # three ties at the top
    base[[5, 21]] = 1.0               # two ties at the 4th/5th value
    rows = [(1.0, 4, 1.0), (1.0, 0, 0.5), (GREEDY_TEMPERATURE, 0, 1.0)]
    keys, temps, topks, topps = _lane_args(rows, 7)
    n = 200
    logits = np.broadcast_to(base, (len(rows), n, v)).copy()
    index = np.broadcast_to(np.arange(n, dtype=np.int32), (len(rows), n)).copy()
    got, want = _both_sample_lanes(logits, keys, index, temps, topks, topps)
    np.testing.assert_array_equal(got, want)
    kept = sampling.filtered_logits(
        torch.as_tensor(logits[:2, 0]), torch.as_tensor(temps[:2]),
        torch.as_tensor(topks[:2]), torch.as_tensor(topps[:2]),
    )
    assert set(torch.nonzero(torch.isfinite(kept[0])).flatten().tolist()) == {3, 5, 9, 17, 21}
    # top_p 0.5: the boundary is the second of the three tied maxima, and
    # its ties survive with it
    assert set(torch.nonzero(torch.isfinite(kept[1])).flatten().tolist()) == {3, 9, 17}
    assert set(got[0].tolist()) == {3, 5, 9, 17, 21}
    assert set(got[1].tolist()) == {3, 9, 17}
    assert set(got[2].tolist()) == {3}


def test_sample_lanes_frequencies_follow_the_filtered_softmax():
    """At a sharp config (top_k 5, temperature 0.7) 4000 landing indices
    draw each kept token as often as the filtered softmax says: every
    frequency within 4 standard deviations of its probability, nothing
    outside the top 5 drawn."""
    v, n = 64, 4000
    rng = np.random.default_rng(11)
    logits = torch.as_tensor(rng.standard_normal((v,)).astype(np.float32) * 2)
    draws = sampling.sample_lanes(
        logits.expand(1, n, v), _torch_keys(_u32(rng, (1, 2))),
        torch.arange(n)[None, :], torch.tensor([0.7]), torch.tensor([5]),
        torch.tensor([1.0]),
    )[0]
    top = torch.topk(logits, 5).indices
    probs = torch.zeros(v)
    probs[top] = torch.softmax(logits[top] / 0.7, dim=0)
    freq = torch.bincount(draws.long(), minlength=v).float() / n
    sd = (probs * (1 - probs) / n).sqrt()
    assert bool(((freq - probs).abs() <= 4 * sd + 1e-9).all()), (freq[top], probs[top])


# -- the steps with sampling= --------------------------------------------------------

NB, BS, W = 24, 8, 10


@pytest.fixture(scope="module")
def weights():
    """(JAX pytree, port module) holding the same seeded weights, the
    decoder layers scaled by LAYER_SCALE."""
    jp = jax.tree_util.tree_map_with_path(
        _scaled, JaxLlama(JAX_TINY).init(jax.random.key(0))
    )
    model = LlamaForCausalLM(TINY, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), TINY, device="cpu"))
    return jp, model


def _step_sampling(b, seed):
    rows = [LANE_ROWS[i % 4 + 1] if i % 4 else LANE_ROWS[4] for i in range(b)]
    rows[-1] = LANE_ROWS[0]  # the last lane at the greedy sentinel
    keys, temps, topks, topps = _lane_args(rows, seed)
    jax_s = (jnp.asarray(keys), jnp.asarray(temps), jnp.asarray(topks), jnp.asarray(topps))
    port_s = (_torch_keys(keys), torch.as_tensor(temps), torch.as_tensor(topks),
              torch.as_tensor(topps))
    return jax_s, port_s


def _prefilled(weights, tables, prompt):
    """Both decoders, on the gather path (the kernel's is held by
    tests/test_torch_speculative.py; here the draws are), each with a
    fresh pool after one whole-prompt prefill of ``prompt``."""
    jp, model = weights
    jdec = JaxLlamaDecode(dataclasses.replace(JAX_TINY, use_paged_kernel=False))
    tdec = LlamaDecode(dataclasses.replace(TINY, use_paged_kernel=False))
    jcache = jdec.init_paged_cache(NB, BS)
    tcache = tdec.init_paged_cache(NB, BS, device="cpu")
    b = prompt.shape[0]
    # jitted: the JAX package's eager ops compile one program each
    _, jcache = jax.jit(lambda p, c, ids, pos, tb: jdec.forward(
        p, c, ids, pos, None, block_tables=tb, context_encode=True,
    ))(jp, jcache, jnp.asarray(prompt, jnp.int32), jnp.zeros((b,), jnp.int32),
       jnp.asarray(tables))
    tdec.forward(
        model, tcache, torch.as_tensor(prompt), torch.zeros((b,), dtype=torch.int32),
        block_tables=torch.as_tensor(tables), context_encode=True,
    )
    return jdec, tdec, jcache, tcache


def _sampled_chain(weights, tables, prompt, cur, pos, k, port_s):
    """k sampled decode steps of the port from (cur, pos) on a scratch pool:
    the drafts a sampled verify accepts in full. Returns (b, k)."""
    _, model = weights
    _, tdec, _, cache = _prefilled(weights, tables, prompt)
    tok = torch.as_tensor(cur, dtype=torch.int32)
    p = torch.as_tensor(pos, dtype=torch.int32)
    out = []
    for _ in range(k):
        tok, p, cache = tdec.decode_step(model, cache, tok, p, torch.as_tensor(tables),
                                         sampling=port_s)
        out.append(tok)
    return torch.stack(out, dim=1).numpy()


def _step_case(weights, lanes, k, seed):
    rng = np.random.default_rng(seed)
    plen = 13
    prompt = rng.integers(0, TINY.vocab_size, size=(lanes, plen))
    tables = np.zeros((lanes, W), np.int32)
    tables[:, :3] = [[3, 5, 7], [2, 9, 4], [11, 6, 8], [10, 12, 13]][:lanes]
    cur = rng.integers(0, TINY.vocab_size, size=(lanes,)).astype(np.int32)
    jax_s, port_s = _step_sampling(lanes, seed)
    chain = _sampled_chain(weights, tables, prompt, cur, [plen] * lanes, k, port_s)
    return rng, prompt, tables, cur, chain, jax_s, port_s


def _jax_step(dec, name, jp, jcache, args, **kw):
    """``dec.<name>(jp, jcache, *args, kv_limit=32, pos_cap=79, **kw)``,
    jitted."""
    fn = getattr(dec, name)
    return jax.jit(lambda p, c, a, k: fn(p, c, *a, kv_limit=32, pos_cap=79, **k))(
        jp, jcache, tuple(jnp.asarray(a) for a in args), kw)


def _assert_same(j_out, t_out, n):
    for jx, tx in zip(j_out[:n], t_out[:n]):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_decode_step_sampling_matches_jax(weights):
    """decode_step(sampling=) draws JAX's tokens at landing index
    positions + 1, and advances the positions as JAX does."""
    jp, model = weights
    _, prompt, tables, cur, _, jax_s, port_s = _step_case(weights, 4, 1, 21)
    pos = np.full((4,), 13, np.int32)
    jdec, tdec, jcache, tcache = _prefilled(weights, tables, prompt)
    j_out = _jax_step(jdec, "decode_step", jp, jcache, (cur, pos, tables), sampling=jax_s)
    t_out = tdec.decode_step(model, tcache, torch.as_tensor(cur), torch.as_tensor(pos),
                             torch.as_tensor(tables), kv_limit=32, pos_cap=79,
                             sampling=port_s)
    _assert_same(j_out, t_out, 2)
    assert t_out[0].dtype == torch.int32


def test_verify_step_sampling_matches_jax(weights):
    """verify_step(sampling=) with k = 4: lane 0 the sampled chain (accepted
    in full, the bonus drawn at position + 5), lane 1 the chain capped at
    draft_len 2, lane 2 random drafts, lane 3 the greedy sentinel with the
    chain. Emitted, accept, new tokens and positions equal JAX's."""
    jp, model = weights
    k = 4
    rng, prompt, tables, cur, chain, jax_s, port_s = _step_case(weights, 4, k, 22)
    drafts = chain.copy()
    drafts[2] = rng.integers(0, TINY.vocab_size, size=(k,))
    tokens = np.concatenate([cur[:, None], drafts], axis=1).astype(np.int32)
    draft_len = np.asarray([k, 2, k, k], np.int32)
    pos = np.full((4,), 13, np.int32)
    jdec, tdec, jcache, tcache = _prefilled(weights, tables, prompt)
    args = (tokens, pos, tables, draft_len)
    j_out = _jax_step(jdec, "verify_step", jp, jcache, args, sampling=jax_s)
    t_out = tdec.verify_step(model, tcache, *(torch.as_tensor(a) for a in args),
                             kv_limit=32, pos_cap=79, sampling=port_s)
    _assert_same(j_out, t_out, 4)
    assert t_out[1].tolist()[:2] == [k, 2] and t_out[1].tolist()[3] == k


def test_tree_verify_step_sampling_matches_jax(weights):
    """tree_verify_step(sampling=): lane 0 a decoy branch beside the sampled
    chain (accepted through the second branch, each node's target drawn
    at position + 1 + depth), lane 1 a random tree, lane 2 the chain.
    Emitted, accept, new tokens and positions equal JAX's."""
    jp, model = weights
    k = 5
    rng, prompt, tables, cur, chain, jax_s, port_s = _step_case(weights, 3, k, 23)
    tokens = np.zeros((3, k + 1), np.int32)
    parents = np.zeros((3, k + 1), np.int32)
    tokens[:, 0] = cur
    decoy = (int(chain[0, 0]) + 1) % TINY.vocab_size
    tokens[0, 1:] = [decoy] + chain[0, : k - 1].tolist()
    parents[0] = [0, 0, 0] + list(range(2, k))
    tokens[1, 1:] = rng.integers(0, TINY.vocab_size, size=(k,))
    for j in range(1, k + 1):
        parents[1, j] = rng.integers(0, j)
    tokens[2, 1:] = chain[2]
    parents[2] = np.maximum(np.arange(k + 1) - 1, 0)
    node_len = np.asarray([k + 1, k - 1, k + 1], np.int32)
    pos = np.full((3,), 13, np.int32)
    jdec, tdec, jcache, tcache = _prefilled(weights, tables, prompt)
    args = (tokens, pos, tables, parents, node_len)
    j_out = _jax_step(jdec, "tree_verify_step", jp, jcache, args, sampling=jax_s)
    t_out = tdec.tree_verify_step(model, tcache, *(torch.as_tensor(a) for a in args),
                                  kv_limit=32, pos_cap=79, sampling=port_s)
    _assert_same(j_out, t_out, 4)
    assert t_out[1].tolist()[0] == k - 1 and t_out[1].tolist()[2] == k


@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_mixed_step_sampling_matches_jax(weights, tree):
    """mixed_step(sampling=) at t = 6: lane 0 a forced chunk of 5 rows at
    row 8 (its token drawn at row_start + row_len), lane 1 a verify of the
    sampled chain, lane 2 a plain decode, lane 3 idle at the greedy
    sentinel; with ``parents`` lane 1 carries a decoy tree. Every integer
    output equals JAX's."""
    jp, model = weights
    t = 6
    rng, prompt, tables, cur, chain, jax_s, port_s = _step_case(weights, 4, t - 1, 24)
    rows = np.zeros((4, t), np.int32)
    rows[0, :5] = prompt[0, 8:13]
    parents = np.zeros((4, t), np.int32)
    if tree:
        decoy = (int(chain[1, 0]) + 1) % TINY.vocab_size
        rows[1, : t - 1] = [decoy] + chain[1, : t - 2].tolist()
        parents[1] = [0, 0, 0] + list(range(2, t - 1))
        row_len = np.asarray([5, t - 1, 0, 0], np.int32)
    else:
        rows[1, :3] = chain[1, :3]
        row_len = np.asarray([5, 3, 0, 0], np.int32)
    row_start = np.asarray([8, 0, 0, 0], np.int32)
    forced = np.asarray([1, 0, 0, 0], np.int32)
    pos = np.asarray([13, 13, 13, 0], np.int32)
    jdec, tdec, jcache, tcache = _prefilled(weights, tables, prompt)
    args = (cur, pos, tables, rows, row_start, row_len, forced)
    jkw = dict(parents=jnp.asarray(parents)) if tree else {}
    tkw = dict(parents=torch.as_tensor(parents)) if tree else {}
    j_out = _jax_step(jdec, "mixed_step", jp, jcache, args, sampling=jax_s, **jkw)
    t_out = tdec.mixed_step(model, tcache, *(torch.as_tensor(a) for a in args),
                            kv_limit=32, pos_cap=79, sampling=port_s, **tkw)
    _assert_same(j_out, t_out, 4)
    assert t_out[1].tolist()[:2] == [4, t - 2 if tree else 3]


# -- the engine ------------------------------------------------------------------------


def _gen(max_new, sampled=True, **kw):
    return GenerationConfig(max_new_tokens=max_new,
                            sampling=SamplingConfig(**SAMPLED) if sampled else SamplingConfig(),
                            **kw)


def _port(model, gen, drafter=None, **paged_kw):
    return PagedServingEngine(
        InferenceEngine(TINY, model, **ENGINE_KW), gen, PagedConfig(**dict(POOL, **paged_kw)),
        drafter=drafter,
    )


def _jax(jp, max_new, sampled=True, drafter=None, **paged_kw):
    from neuronx_distributed_llama3_2_tpu.inference.sampling import (
        SamplingConfig as JaxSamplingConfig,
    )

    s = JaxSamplingConfig(**SAMPLED) if sampled else JaxSamplingConfig()
    return JaxPagedServingEngine(
        JaxInferenceEngine(JAX_TINY, jp, **ENGINE_KW),
        JaxGenerationConfig(max_new_tokens=max_new, sampling=s),
        JaxPagedConfig(**dict(POOL, **paged_kw)), drafter=drafter, precompile=False,
    )


def _run(eng, prompts):
    for p in prompts:
        eng.submit(p)
    out = eng.run_to_completion()
    assert eng._pending is None
    assert eng.allocator.active_blocks == 0
    assert eng.allocator.leak_check() == []
    return out


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY.vocab_size, size=(n,)).tolist() for n in lengths]


class _TailDrafter:
    """Always proposes: the history's last tokens, and as a tree a branch
    of one node beside a chain. Sampled streams seldom repeat, so the
    n-gram drafter would abstain; holds no state, so both engines of a
    comparison share it."""

    def propose(self, history, max_tokens):
        return list(history[-max_tokens:])

    def propose_tree(self, history, max_tokens, branches):
        nodes = self.propose(history, max_tokens)
        return nodes, ([0, 0] + list(range(2, len(nodes))))[: len(nodes)]


class _StreamDrafter(_TailDrafter):
    """Proposes the continuation of the one of ``seqs`` (prompt + the
    plain sampled stream) that ``history`` starts, so that sampled drafts
    are accepted; as a tree, a decoy node first and the continuation on
    the second branch."""

    def __init__(self, seqs):
        self.seqs = seqs

    def propose(self, history, max_tokens):
        for s in self.seqs:
            if s[: len(history)] == list(history):
                return s[len(history): len(history) + max_tokens]
        return []

    def propose_tree(self, history, max_tokens, branches):
        chain = self.propose(history, max_tokens - 1)
        if not chain:
            return [], []
        decoy = (chain[0] + 1) % TINY.vocab_size
        return [decoy] + chain, [0, 0] + list(range(2, len(chain) + 1))


COUNTERS = (
    "sampled_steps", "host_sample_fallbacks", "rng_reseeds", "decode_steps",
    "decode_steps_async", "lame_duck_tokens", "verify_steps", "draft_tokens",
    "accepted_tokens", "mixed_dispatches", "prefill_chunks", "preemptions",
    "tree_verify_steps",
)

#: (id, max_new_tokens, prompts, the port's PagedConfig knobs, the JAX
#: engine's): prewarm runs the port's records (eagerly on the CPU) against
#: the JAX engine without prewarm, whose streams its prewarm leaves as
#: they are
JAX_LEGS = {
    "bf16": (8, _prompts(3, (5, 12, 20, 9)), {}, {}),
    "int8-chunked": (8, _prompts(3, (5, 12, 20, 9)),
                     dict(kv_cache_dtype="int8", prefill_chunk_tokens=6), None),
    "spec-fused": (10, _prompts(31, (9, 26, 12, 7)),
                   dict(spec_draft_tokens=3, prefill_chunk_tokens=6, fused_step=True), None),
    "tree-fused": (10, _prompts(31, (9, 26, 12, 7)),
                   dict(spec_draft_tokens=3, spec_tree=True, prefill_chunk_tokens=6,
                        fused_step=True), None),
    "prewarm": (8, _prompts(3, (5, 12, 20, 9)), dict(prewarm=True), {}),
    "async": (8, _prompts(3, (5, 12, 20, 9)), dict(async_loop=True), None),
    "preempt-resume": (24, _prompts(5, (12, 12, 12, 12)),
                       dict(num_blocks=10, decode_reserve_blocks=1), None),
}


@pytest.mark.parametrize("leg", sorted(JAX_LEGS))
def test_sampled_streams_match_jax(weights, leg):
    """The port's sampled streams and counters under on_device_sampling
    equal JaxPagedServingEngine(on_device_sampling=True)'s, token for
    token: the draws are JAX's, keyed by the same landing indices."""
    jp, model = weights
    max_new, prompts, port_kw, jax_kw = JAX_LEGS[leg]
    jax_kw = port_kw if jax_kw is None else jax_kw
    drafter = _TailDrafter() if "spec_draft_tokens" in port_kw else None
    jax_eng = _jax(jp, max_new, on_device_sampling=True, drafter=drafter, **jax_kw)
    port = _port(model, _gen(max_new), on_device_sampling=True, drafter=drafter, **port_kw)
    j_out, p_out = _run(jax_eng, prompts), _run(port, prompts)
    assert p_out == j_out
    jm, pm = jax_eng.metrics, port.metrics
    assert {c: getattr(pm, c) for c in COUNTERS} == {c: getattr(jm, c) for c in COUNTERS}
    assert pm.sampled_steps > 0 and pm.host_sample_fallbacks == 0
    assert pm.rng_reseeds == len(prompts) + pm.preemptions
    if leg == "preempt-resume":
        assert pm.preemptions > 0
    if leg.startswith(("spec", "tree")):
        assert pm.verify_steps > 0 and pm.mixed_dispatches > 0
    if leg == "prewarm":
        recs = port.program_registry().values()
        assert sum(r.replays for r in recs) == pm.compute_dispatches
        assert all(r.key[0] in ("pverify", "ptree") or "lane" in r.key for r in recs)


@pytest.mark.parametrize("async_loop", [False, True], ids=["sync", "async"])
def test_fused_greedy_identity(weights, async_loop):
    """A greedy config under on_device_sampling (the temperature sentinel,
    exact argmax) gives the streams of the engine without it; no dispatch
    counts as sampled, and every admission installs a key."""
    _, model = weights
    prompts = _prompts(3, (5, 12, 20, 9))
    want = _run(_port(model, _gen(8, sampled=False), async_loop=async_loop), prompts)
    fused = _port(model, _gen(8, sampled=False), async_loop=async_loop,
                  on_device_sampling=True)
    assert _run(fused, prompts) == want
    m = fused.metrics
    assert m.sampled_steps == 0 and m.host_sample_fallbacks == 0
    assert m.rng_reseeds == len(prompts)
    assert len({tuple(o) for o in want.values()}) == len(prompts)


def test_sampled_run_metrics_and_determinism(weights):
    """A sampled fused serve: full-length streams, sampled dispatches
    counted, no host fallback; a fresh engine with the same seed gives the
    same streams, another seed other streams, and the greedy engine
    others again."""
    _, model = weights
    prompts = _prompts(4, (5, 12, 20, 9))
    eng = _port(model, _gen(8), on_device_sampling=True)
    out = _run(eng, prompts)
    assert all(len(o) == 8 for o in out.values())
    assert eng.metrics.sampled_steps > 0 and eng.metrics.host_sample_fallbacks == 0
    assert _run(_port(model, _gen(8), on_device_sampling=True), prompts) == out
    assert _run(_port(model, _gen(8, seed=1), on_device_sampling=True), prompts) != out
    assert _run(_port(model, _gen(8, sampled=False)), prompts) != out


def test_host_sampling_counts_fallbacks(weights):
    _, model = weights
    eng = _port(model, _gen(6))
    _run(eng, _prompts(5, (5, 9)))
    assert eng.metrics.host_sample_fallbacks > 0 and eng.metrics.sampled_steps == 0
    assert eng.metrics.rng_reseeds == 0


@pytest.mark.parametrize("async_loop", [False, True], ids=["sync", "async"])
def test_sampled_steady_state_zero_uploads(weights, async_loop):
    """An event-free sampled decode step uploads nothing, sync and async:
    the sampling parameters and keys are residents, as the JAX engine's
    are, whose per-step upload counts the port's equal."""
    jp, model = weights
    prompt = _prompts(0, (4,))[0]
    deltas = []
    for eng in (
        _jax(jp, 20, on_device_sampling=True, block_size=32, num_blocks=8,
             async_loop=async_loop),
        _port(model, _gen(20), on_device_sampling=True, block_size=32, num_blocks=8,
              async_loop=async_loop),
    ):
        eng.submit(prompt)
        eng.step()  # admission and prefill
        eng.step()  # the first decode dispatch flushes the dirty lane
        m = eng.metrics
        steps = []
        for _ in range(12):
            before = m.h2d_uploads
            assert eng.step()
            steps.append(m.h2d_uploads - before)
        eng.run_to_completion()
        assert m.sampled_steps > 0 and m.host_sample_fallbacks == 0
        deltas.append(steps)
    assert deltas[1] == deltas[0] == [0] * 12


@pytest.mark.parametrize("sampled,fused,label", [
    (True, True, "fused"), (False, True, "greedy"), (True, False, "host"),
], ids=["fused", "greedy", "host"])
def test_tracer_sampling_labels(weights, sampled, fused, label):
    """Every decode, verify and mixed dispatch on the tracer's timeline
    carries its sampling label: fused, greedy (either mode) or host."""
    _, model = weights
    eng = _port(model, _gen(4, sampled=sampled), on_device_sampling=fused)
    eng.tracer = EngineTracer(enabled=True, buffer_steps=64)
    _run(eng, _prompts(8, (5, 9)))
    dispatches = [e for e in eng.tracer.chrome_events() if e["name"] == "dispatch"]
    assert len(dispatches) == eng.metrics.decode_steps
    assert {e["args"]["sampling"] for e in dispatches} == {label}
    assert all(e["args"]["program"].startswith("pdecode[") for e in dispatches)


@pytest.mark.parametrize("async_loop", [False, True], ids=["sync", "async"])
def test_sampled_preempt_resume_replays_stream(weights, async_loop):
    """Pool contention preempts and resumes sampled requests; with each
    draw keyed by its landing index and the base key re-installed from
    (seed, rid), the contended run replays the uncontended streams."""
    _, model = weights
    prompts = _prompts(5, (12, 12, 12, 12))
    want = _run(_port(model, _gen(24), on_device_sampling=True, async_loop=async_loop),
                prompts)
    eng = _port(model, _gen(24), on_device_sampling=True, async_loop=async_loop,
                num_blocks=10, decode_reserve_blocks=1)
    assert _run(eng, prompts) == want
    assert eng.metrics.preemptions > 0


def test_spec_and_fused_step_need_fused_sampling_for_sampled_traffic(weights):
    _, model = weights
    for kw in (dict(spec_draft_tokens=4), dict(prefill_chunk_tokens=4, fused_step=True)):
        with pytest.raises(ValueError, match="on_device_sampling"):
            _port(model, _gen(6), **kw)
        _port(model, _gen(6), on_device_sampling=True, **kw)


@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_sampled_spec_matches_non_spec_stream(weights, tree):
    """Sampled speculation (with the fused step) gives the streams of the
    plain sampled serve: both draw token i with fold_in(lane key, i). The
    drafter proposes the plain stream's continuation (as a tree, behind a
    decoy node), so drafts are accepted and, on a tree, committed from the
    second branch."""
    _, model = weights
    prompts = _prompts(13, (12, 18, 9, 14))
    want = _run(_port(model, _gen(10), on_device_sampling=True), prompts)
    drafter = _StreamDrafter([p + want[r] for r, p in enumerate(prompts)])
    eng = _port(model, _gen(10), drafter=drafter, on_device_sampling=True,
                spec_draft_tokens=4, spec_tree=tree, prefill_chunk_tokens=6,
                fused_step=True)
    assert _run(eng, prompts) == want
    assert eng.metrics.verify_steps > 0 and eng.metrics.accepted_tokens > 0


def test_fused_catalog_uses_lane_sentinel(weights):
    """The catalog's sampling slot is the "lane" sentinel, whatever the
    config: one program serves them all, and the lines are the JAX
    engine's."""
    jp, model = weights
    eng = _port(model, _gen(4), on_device_sampling=True)
    keys = eng.catalog.keys()
    assert any(k[0] == "pdecode" and k[1] == "lane" for k in keys)
    assert "cfg=lane" in eng.catalog.describe()
    assert eng.catalog.lines() == _jax(jp, 4, on_device_sampling=True).catalog.lines()
    assert eng.catalog.keys() == _port(model, _gen(4, sampled=False),
                                       on_device_sampling=True).catalog.keys()


def test_sampled_prewarm_needs_fused_sampling(weights):
    """prewarm with a sampled config: the engine builds every record under
    on_device_sampling, and still raises without it."""
    _, model = weights
    with pytest.raises(NotImplementedError, match="on_device_sampling"):
        _port(model, _gen(4), prewarm=True)
    eng = _port(model, _gen(4), prewarm=True, on_device_sampling=True)
    assert [r.key for r in eng.program_registry().values()] == eng.catalog.graph_keys()
