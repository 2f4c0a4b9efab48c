"""The port's parallel layer (parallel/) against the JAX package, on the CPU.

The checks that need ranks run in spawned processes over gloo
(``tests/torch_dist_workers.py``), at (tp 2), (tp 4, SP) and (tp 2 x dp
2), all in one spawn and one test per mesh: the mesh layout and the getters (the cases of
``tests/test_parallel_state.py``), each Megatron region's forward and
backward against its dense numpy meaning, each TP layer against the JAX
layer's dense math and ``jax.grad`` (kv sharded, flat-sharded and
replicated for the GQA projection), the vocab-parallel cross-entropy
against JAX's ``cross_entropy`` with and without label smoothing, and the
global norm with a replicated leaf counted once. ``pad.py`` is held against
the JAX package's padding in one process.

Tolerance: fp32 sums in another order, 1e-5 absolute on values of order 1
(the regions move values without arithmetic and are exact).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.models import llama as jllama
from neuronx_distributed_llama3_2_tpu.parallel import layers as jlayers
from neuronx_distributed_llama3_2_tpu.parallel import loss as jloss
from neuronx_distributed_llama3_2_tpu.parallel import pad as jpad
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama
from neuronx_distributed_llama3_2_tpu_torch.parallel import pad as tpad
from neuronx_distributed_llama3_2_tpu_torch.parallel import state as tstate

from tests import torch_dist_workers as W

ATOL = 1e-5
B, S = 2, 8
#: GQA head layouts: key -> (N, NKV, D); at tp 4, "flat" splits the flat kv
#: width and "rep" replicates the kv kernels
GQA = {"shard": (8, 4, 4), "flat": (8, 2, 8), "rep": (12, 3, 4)}
#: spawned meshes: id -> (world, tp, sequence_parallel)
MESHES = {"tp2": (2, 2, False), "tp4_sp": (4, 4, True), "tp2_dp2": (4, 2, False)}


def _inputs():
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inp = dict(
        x=f(B, S, 8), g=f(B, 4 * S, 32),
        xin=f(B, S, 16), w_col=f(16, 24), b_col=f(24), gy_col=f(B, S, 24),
        xrow=f(B, S, 24), w_row=f(24, 16), b_row=f(16), gy_row=f(B, S, 16),
        ids=rng.integers(0, 32, (B, S)), w_emb=f(32, 16), gy_emb=f(B, S, 16),
        logits=f(B, S, 32) * 3, w_ce=f(B, S),
        labels=np.array([[0, 5, 31, -100, 7, 40, 16, 17], [1, 2, 3, 4, -5, 30, 8, 9]]),
        gqa=GQA,
    )
    for key, (n, nkv, d) in GQA.items():
        for nm, width in (("q", n * d), ("k", nkv * d), ("v", nkv * d)):
            inp[f"gqa_{key}_w{nm}"] = f(16, width)
            inp[f"gqa_{key}_b{nm}"] = f(width)
        inp[f"gqa_{key}_gq"] = f(B, S, n * d)
    return inp


def _kv_select(k, n, nkv, d, tp, r):
    """JAX's per-rank kv heads (the tensor each rank's attention reads):
    sharded -> its NKV/tp heads; flat -> its copy of head r // m after the
    m-fold repeat; replicated -> the kv head of each of its q heads."""
    heads = k.reshape(B, S, nkv, d)
    if nkv % tp == 0:
        w = nkv // tp
        return heads[:, :, r * w:(r + 1) * w].reshape(B, S, -1)
    if tp % nkv == 0 and (nkv * d) % tp == 0 and n % tp == 0:
        return heads[:, :, r // (tp // nkv)]
    nl = n // tp
    return heads[:, :, (r * nl + jnp.arange(nl)) // (n // nkv)].reshape(B, S, -1)


def _add_gqa_grads(inputs, tp):
    """The per-rank upstream gradients of k and v: one (B, S, local) array
    per tp rank, drawn from a seed."""
    rng = np.random.default_rng(11)
    for key, (n, nkv, d) in GQA.items():
        for nm in ("k", "v"):
            per = [np.asarray(_kv_select(jnp.zeros((B, S, nkv * d)), n, nkv, d, tp, r)).shape
                   for r in range(tp)]
            inputs[f"gqa_{key}_g{nm}"] = [rng.standard_normal(s).astype(np.float32) for s in per]


@functools.lru_cache(maxsize=None)
def _run(mesh):
    import tempfile

    world, tp, sp = MESHES[mesh]
    inputs = _inputs()
    _add_gqa_grads(inputs, tp)
    with tempfile.TemporaryDirectory() as d:
        outs = W.run(W.parallel_worker, world, d, tp, sp, inputs)
    return world, tp, sp, inputs, outs


def _check_mesh_layout_and_getters(mesh):
    world, tp, sp, _, outs = _run(mesh)
    dp = world // tp
    for rank, o in enumerate(outs):
        m = o["mesh"]
        assert m["shape"] == (1, dp, 1, 1, tp)
        assert (m["tp"], m["dp"]) == (tp, dp)
        # tp innermost with stride 1, as JAX's build_mesh lays devices out
        assert (m["dp_rank"], m["tp_rank"]) == divmod(rank, tp)
        assert m["tp_ranks"] == list(range(rank - rank % tp, rank - rank % tp + tp))
        assert m["dp_ranks"] == list(range(rank % tp, world, tp))
        assert m["tp_only"] == (dp == 1)
        assert m["kv4"] == 4 // tp and m["kv3"] == 3
        assert m["sp"] == sp and m["axes"] == ("dp", "ep")


def _check_regions_forward_and_backward(mesh):
    world, tp, _, inputs, outs = _run(mesh)
    x0, g0 = inputs["x"], inputs["g"]
    for rank, o in enumerate(outs):
        r = rank % tp
        xs = [x0 + i for i in range(tp)]
        w = x0.shape[-1] // tp
        s = x0.shape[1] // tp

        def g(shape, i):
            return g0[tuple(slice(0, n) for n in shape)] * (i + 1)

        def cat(parts, dim):
            return np.concatenate(parts, axis=dim)

        want = {
            "copy_to": (xs[r], sum(g(x0.shape, i) for i in range(tp))),
            "reduce_from": (sum(xs), g(x0.shape, r)),
            "gather_from": (cat(xs, -1), g((B, S, 8 * tp), r)[..., r * 8:(r + 1) * 8]),
            "scatter_to": (xs[r][..., r * w:(r + 1) * w],
                           cat([g((B, S, w), i) for i in range(tp)], -1)),
            "sp_scatter_to": (xs[r][:, r * s:(r + 1) * s],
                              cat([g((B, s, 8), i) for i in range(tp)], 1)),
            "sp_gather_from": (cat(xs, 1),
                               sum(g((B, S * tp, 8), i) for i in range(tp))[:, r * S:(r + 1) * S]),
            "sp_gather_from_split": (cat(xs, 1), g((B, S * tp, 8), r)[:, r * S:(r + 1) * S]),
            "sp_reduce_scatter": (sum(xs)[:, r * s:(r + 1) * s],
                                  cat([g((B, s, 8), i) for i in range(tp)], 1)),
        }
        for name, (y, dx) in want.items():
            got_y, got_dx = o["regions"][name]
            np.testing.assert_allclose(got_y, y, atol=ATOL, err_msg=name)
            np.testing.assert_allclose(got_dx, dx, atol=ATOL, err_msg=name)


def _jax_value_and_grads(fn, args, argnums):
    return jax.value_and_grad(fn, argnums=argnums)(*args)


def _check_tp_layers_match_jax(mesh):
    world, tp, _, inp, outs = _run(mesh)
    j = jnp.asarray
    col = jlayers.ColumnParallelLinear(16, 24, use_bias=True)
    row = jlayers.RowParallelLinear(24, 16, use_bias=True)
    emb = jlayers.ParallelEmbedding(32, 16)
    col_y = col({"kernel": j(inp["w_col"]), "bias": j(inp["b_col"])}, j(inp["xin"]))
    _, (dx, dw, db) = _jax_value_and_grads(
        lambda x, w, b: jnp.sum(col({"kernel": w, "bias": b}, x) * inp["gy_col"]),
        (j(inp["xin"]), j(inp["w_col"]), j(inp["b_col"])), (0, 1, 2))
    row_y = row({"kernel": j(inp["w_row"]), "bias": j(inp["b_row"])}, j(inp["xrow"]))
    _, (rdx, rdw, rdb) = _jax_value_and_grads(
        lambda x, w, b: jnp.sum(row({"kernel": w, "bias": b}, x) * inp["gy_row"]),
        (j(inp["xrow"]), j(inp["w_row"]), j(inp["b_row"])), (0, 1, 2))
    emb_y = emb({"embedding": j(inp["w_emb"])}, j(inp["ids"]))
    _, de = _jax_value_and_grads(
        lambda e: jnp.sum(emb({"embedding": e}, j(inp["ids"])) * inp["gy_emb"]),
        (j(inp["w_emb"]),), 0)
    for o in outs:
        lay = o["layers"]
        for key in ("col0", "col1"):
            for got, want in zip(lay[key], (col_y, dx, dw, db)):
                np.testing.assert_allclose(got, want, atol=ATOL, err_msg=key)
        for key in ("row0", "row1"):
            for got, want in zip(lay[key], (row_y, rdx, rdw, rdb)):
                np.testing.assert_allclose(got, want, atol=ATOL, err_msg=key)
        for key in ("emb_vocab", "emb_embed"):
            np.testing.assert_allclose(lay[key][0], emb_y, atol=ATOL)
            np.testing.assert_allclose(lay[key][1], de, atol=ATOL)


def _check_gqa_qkv_kv_layouts_match_jax(mesh):
    world, tp, _, inp, outs = _run(mesh)
    j = jnp.asarray
    modes = set()
    for key, (n, nkv, d) in GQA.items():
        if n % tp:
            continue
        layer = jlayers.GQAQKVColumnParallelLinear(16, n, nkv, d, use_bias=True, tensor_parallel_size=1)
        w = {f"{nm}_{kind}": j(inp[f"gqa_{key}_{'w' if kind == 'kernel' else 'b'}{nm}"])
             for nm in ("q", "k", "v") for kind in ("kernel", "bias")}

        def loss(x, w):
            q, k, v = layer(w, x)
            total = jnp.sum(q * inp[f"gqa_{key}_gq"])
            for r in range(tp):
                total += jnp.sum(_kv_select(k, n, nkv, d, tp, r) * inp[f"gqa_{key}_gk"][r])
                total += jnp.sum(_kv_select(v, n, nkv, d, tp, r) * inp[f"gqa_{key}_gv"][r])
            return total

        q, k, v = layer(w, j(inp["xin"]))
        _, (dx, dw) = jax.value_and_grad(loss, argnums=(0, 1))(j(inp["xin"]), w)
        for rank, o in enumerate(outs):
            r = rank % tp
            got = o["layers"][f"gqa_{key}"]
            modes.add(got["mode"])
            np.testing.assert_allclose(got["q"], q, atol=ATOL)
            np.testing.assert_allclose(got["k"], _kv_select(k, n, nkv, d, tp, r), atol=ATOL)
            np.testing.assert_allclose(got["v"], _kv_select(v, n, nkv, d, tp, r), atol=ATOL)
            np.testing.assert_allclose(got["dx"], dx, atol=ATOL)
            for nm in ("q", "k", "v"):
                np.testing.assert_allclose(got[f"d{nm}"], dw[f"{nm}_kernel"], atol=ATOL, err_msg=(key, nm))
    assert modes == ({"sharded", "replicated"} if tp == 2 else {"sharded", "flat", "replicated"})


def _check_vocab_parallel_cross_entropy_matches_jax(mesh):
    world, tp, _, inp, outs = _run(mesh)
    for ls in (0.0, 0.1):
        loss = jloss.cross_entropy(jnp.asarray(inp["logits"]), jnp.asarray(inp["labels"]), ls)
        grad = jax.grad(lambda lg: jnp.sum(
            jloss.cross_entropy(lg, jnp.asarray(inp["labels"]), ls) * inp["w_ce"]))(
            jnp.asarray(inp["logits"]))
        for o in outs:
            got_loss, got_grad = o["ce"][ls]
            np.testing.assert_allclose(got_loss, loss, atol=ATOL)
            np.testing.assert_allclose(got_grad, grad, atol=ATOL)


def _check_global_norm_counts_replicated_leaves_once(mesh):
    world, tp, _, inp, outs = _run(mesh)
    x0, g0 = inp["x"], inp["g"]
    want = np.sqrt(sum(np.sum((x0[0] * (r + 1)) ** 2) for r in range(tp)) + np.sum(g0[0] ** 2))
    for o in outs:
        np.testing.assert_allclose(o["norm"], want, rtol=1e-6)


def _check_random_streams_per_tp_rank(mesh):
    """The tp stream is seed + 2718 + tp rank (the reference's
    model-parallel stream), the dp stream the seed itself, on every rank."""
    world, tp, _, _, outs = _run(mesh)
    for rank, o in enumerate(outs):
        tp_draw, dp_draw = o["rng"]
        r = rank % tp
        np.testing.assert_array_equal(
            tp_draw, torch.rand(4, generator=torch.Generator().manual_seed(5 + 2718 + r)).numpy())
        np.testing.assert_array_equal(dp_draw, outs[0]["rng"][1])
    assert not np.array_equal(outs[0]["rng"][0], outs[1]["rng"][0])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_parallel_layer_on_a_mesh(mesh):
    """Every check that needs ranks, on one spawn of the mesh's ranks
    (the module docstring lists them)."""
    _check_mesh_layout_and_getters(mesh)
    _check_regions_forward_and_backward(mesh)
    _check_global_norm_counts_replicated_leaves_once(mesh)
    _check_random_streams_per_tp_rank(mesh)
    if mesh in ("tp2", "tp4_sp"):
        _check_tp_layers_match_jax(mesh)
        _check_gqa_qkv_kv_layouts_match_jax(mesh)
        _check_vocab_parallel_cross_entropy_matches_jax(mesh)


# -- one process ---------------------------------------------------------------

@pytest.mark.parametrize("tp", [3, 16])
def test_pad_matches_jax(tp):
    """Padding for a tp that divides neither head count of tiny (8 q, 4 kv
    heads): the same plan and the same padded weights as the JAX package,
    and the padded model's logits equal the unpadded model's."""
    cfg = tllama.LLAMA_CONFIGS["tiny"]
    jcfg = jllama.LLAMA_CONFIGS["tiny"]
    assert tpad.gqa_padding_plan(8, 4, tp) == jpad.gqa_padding_plan(8, 4, tp)
    assert tpad.get_number_of_extra_heads(8, tp) == jpad.get_number_of_extra_heads(8, tp)
    jp = jax.tree.map(np.asarray, jllama.LlamaForCausalLM(jcfg).init(jax.random.key(0)))
    jcfg2, jpadded = jpad.pad_llama_params_for_tp(jp, jcfg, tp)
    sd = tllama.params_from_jax(jp, cfg, device="cpu")
    cfg2, padded = tpad.pad_llama_params_for_tp(sd, cfg, tp)
    assert (cfg2.num_heads, cfg2.num_kv_heads) == (jcfg2.num_heads, jcfg2.num_kv_heads)
    got = dict(_leaves(tllama.params_to_jax(padded, cfg2)))
    for path, want in _leaves(jax.tree.map(np.asarray, jpadded)):
        np.testing.assert_array_equal(got[path], want, err_msg=str(path))
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (2, 12)))
    m1 = tllama.LlamaForCausalLM(cfg, device="cpu")
    m1.load_state_dict(sd)
    m2 = tllama.LlamaForCausalLM(cfg2, device="cpu")
    m2.load_state_dict(padded)
    np.testing.assert_allclose(m2(ids).numpy(), m1(ids).numpy(), atol=1e-5)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_unported_axes_raise_naming_their_item():
    for kw, item in (({"pipeline_model_parallel_size": 2}, "item 3"),
                     ({"expert_model_parallel_size": 2}, "item 4")):
        with pytest.raises(NotImplementedError, match=item):
            tstate.initialize_model_parallel(device="cpu", **kw)
    with pytest.raises(ValueError):
        tstate.ParallelConfig(tensor_parallel_size=0)
    with pytest.raises(ValueError, match="both shard the sequence"):
        tstate.ParallelConfig(sequence_parallel=True, context_parallel_size=2)


def test_getters_without_a_mesh():
    assert not tstate.model_parallel_is_initialized()
    with pytest.raises(RuntimeError):
        tstate.get_parallel_state()
    assert tstate.tensor_parallel_size_or(5) == 5
    assert not tstate.mesh_is_tp_only()
    assert tstate.kv_head_shard_size(8) == 8
    assert not tstate.sequence_parallel_enabled()
