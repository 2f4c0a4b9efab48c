"""The port's Mllama family (parallel/conv.py, models/mllama.py) against the
JAX package's, on the CPU, in fp32, mirroring ``tests/test_mllama.py``.

The JAX package's tiny configs (``tests/test_mllama.py``'s: 3 + 2 vision
layers, 4 text layers with cross-attention at 1 and 3; and
``tiny-mllama``) and its ``init`` weights, every gate set to a seeded
non-zero value first (at init every gate is zero and the image moves no
logit), go through both packages on the same inputs: two images of
aspect ratios (1, 1) and (1, 2), the first with one of its two tiles
invalid, and text rows before the image that attend nothing.

- the vision tower's output, the logits, the cross-attention mask and its
  full rows, the loss and every gradient leaf (and, with the cross gates
  at their zero init, those gates' gradients non-zero);
- vision and text ``remat="full"`` equal to ``"none"``;
- the group pattern: regular (the grouped stacks), irregular and all-cross
  (the list layout, ``layers.[i]``), the 11B's ``(8, 5, 3)``;
- ``params_from_jax`` -> ``params_to_jax`` bit for bit, both layouts;
  model tags crossing both ways;
- a bf16 forward within its band of the fp32 one, and the image witness
  (a second image moves the logits past that band);
- ``resolve_model`` and the two scripts' refusals.

Tolerances: fp32 logits and vision features 1e-5 absolute + 1e-4
relative; gradients 1e-5 of the leaf's largest element (floor 1e-3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.models import mllama as J
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama
from neuronx_distributed_llama3_2_tpu_torch.models import mllama as M

torch.set_num_threads(1)

JTINY = J.MllamaConfig(
    vision=J.MllamaVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_global_layers=2,
        attention_heads=2, image_size=28, patch_size=14, max_num_tiles=2,
        max_aspect_ratio_id=3, intermediate_layers_indices=(0, 2),
    ),
    text=J.MllamaTextConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_heads=4, num_kv_heads=2, cross_attention_layers=(1, 3), rope_theta=10000.0,
        max_seq_len=64,
    ),
)

#: bf16 logits against fp32 on the tiny model (max abs gap; it read
#: 0.00259 on the CPU, with logits up to 0.41); the image witness must
#: move the logits past it (it read 0.0267)
BF16_BAND = 0.008


def port_config(jcfg: "J.MllamaConfig", **text_kw) -> M.MllamaConfig:
    """The port's config of a JAX one (same fields, torch dtypes)."""
    def conv(c, cls):
        kw = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
        kw["dtype"] = torch.bfloat16 if c.dtype == jnp.bfloat16 else torch.float32
        return cls(**kw)

    text = dataclasses.replace(conv(jcfg.text, M.MllamaTextConfig), **text_kw)
    return M.MllamaConfig(vision=conv(jcfg.vision, M.MllamaVisionConfig), text=text)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _is_gate(path) -> bool:
    return path[-1] in ("gate", "gate_attn", "gate_ffn", "cross_attn_attn_gate",
                        "cross_attn_mlp_gate")


def with_gates(tree, seed: int = 11, cross: bool = True):
    """A numpy copy of a JAX tree with every gate drawn from ``seed``
    (0.3-0.9 in magnitude, either sign); with ``cross`` False the text
    cross-attention gates keep their zero init."""
    rng = np.random.default_rng(seed)

    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(t)]
        a = np.array(t, dtype=np.float32)
        if _is_gate(path) and (cross or not path[-1].startswith("cross_attn_")):
            a = (rng.uniform(0.3, 0.9, a.shape) * rng.choice([-1.0, 1.0], a.shape)).astype(
                np.float32)
        return a

    return walk(tree)


@functools.lru_cache(maxsize=None)
def jax_params(jcfg=JTINY, seed: int = 0, cross: bool = True):
    """Weights in the JAX package's tree, drawn from ``seed`` (the port's
    ``init_weights``, carried across; JAX's own ``init`` is slow on the CPU
    and the bridge test holds the trees' layouts equal), gates seeded."""
    cfg = port_config(jcfg)
    model = M.MllamaForConditionalGeneration(cfg, device="cpu").init_weights(seed)
    return with_gates(M.params_to_jax(dict(model.named_parameters()), cfg), cross=cross)


def inputs(seed: int = 0, b: int = 2, s: int = 24, tiles: int = 2, image_size: int = 28,
           vocab: int = 128):
    """tests/test_mllama.py's inputs: aspect ratios (1, 1) and (1, 2), the
    first image with its second tile invalid, text attending image 0's
    valid tiles from position 4 on."""
    rng = np.random.default_rng(seed)
    pix = rng.standard_normal((b, 1, tiles, 3, image_size, image_size)).astype(np.float32)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int64)
    ar_ids = np.array([[1], [2]])[:b]
    ar_mask = np.array([[[1, 0]], [[1, 1]]])[:b]
    xmask = np.zeros((b, s, 1, tiles), np.int64)
    xmask[0, 4:, 0, 0] = 1
    xmask[1 % b, 4:, 0, :] = 1
    return pix, ids, ar_ids, ar_mask, xmask


def port_model(jcfg=JTINY, params=None, **text_kw):
    cfg = port_config(jcfg, **text_kw)
    model = M.MllamaForConditionalGeneration(cfg, device="cpu")
    model.load_state_dict(M.params_from_jax(params if params is not None else jax_params(jcfg),
                                            cfg, device="cpu"))
    return cfg, model


def _t(arrs):
    return [torch.as_tensor(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def jax_logits(jcfg, p, batch):
    pix, ids, ar_ids, ar_mask, xmask = _j(batch)
    return np.asarray(jax.jit(J.MllamaForConditionalGeneration(jcfg).__call__)(
        p, ids, pix, ar_ids, ar_mask, xmask))


def port_logits(model, batch):
    pix, ids, ar_ids, ar_mask, xmask = _t(batch)
    return model(ids, pix, ar_ids, ar_mask, xmask).float().numpy()


def assert_grads(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-3)
        assert np.abs(got[path] - w).max() <= 1e-5 * scale, path


def test_vision_tower_matches_jax():
    p = jax_params()
    cfg, model = port_model()
    pix, _, ar_ids, ar_mask, _ = inputs()
    want = jax.jit(J.MllamaVisionModel(JTINY.vision).__call__)(
        p["vision_model"], *_j((pix, ar_ids, ar_mask)))
    with torch.no_grad():
        got = model.vision_model(*_t((pix, ar_ids, ar_mask)))
    assert got.shape == (2, 1, 2, JTINY.vision.num_patches, JTINY.vision.output_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_logits_match_jax():
    batch = inputs()
    _, model = port_model()
    np.testing.assert_allclose(port_logits(model, batch), jax_logits(JTINY, jax_params(), batch),
                               rtol=1e-4, atol=1e-5)


def test_cross_attention_mask_and_full_rows():
    _, _, _, _, xmask = inputs()
    jb, jf = J.prepare_cross_attention_mask(jnp.asarray(xmask), JTINY.vision.num_patches)
    tb, tf = M.prepare_cross_attention_mask(torch.as_tensor(xmask), JTINY.vision.num_patches)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    # the rows before the image attend nothing: flagged 0, their bias zeroed
    assert tf.shape == (2, 1, 24, 1)
    np.testing.assert_array_equal(tf[0, 0, :, 0].numpy(), [0.0] * 4 + [1.0] * 20)
    assert float(tb[0, 0, :4].abs().max()) == 0.0
    # image 0's second tile is not attended: its tokens carry NEG
    P = JTINY.vision.num_patches
    assert float(tb[0, 0, 5, P:].max()) == float(np.float32(M.NEG)) and float(tb[1, 0, 5].min()) == 0.0


@pytest.mark.parametrize("cross_gates", ["seeded", "zero init"])
def test_loss_and_every_gradient_match_jax(cross_gates):
    cross = cross_gates == "seeded"
    p = jax_params(cross=cross)
    cfg, model = port_model(params=p)
    batch = inputs()
    pix, ids, ar_ids, ar_mask, xmask = _j(batch)
    jm = J.MllamaForConditionalGeneration(JTINY)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q: jm.loss(q, ids, ids, pix, ar_ids, ar_mask, xmask)))(p)
    tpix, tids, tar, tarm, txm = _t(batch)
    params = dict(model.named_parameters())
    loss = model.loss(tids, tids, tpix, tar, tarm, txm)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = M.params_to_jax(dict(zip(params, grads)), cfg)
    assert_grads(got, jax.tree.map(np.asarray, jgrads))
    # the cross-attention gates (zero at init) receive gradient
    assert np.abs(got["layers"]["xattn"]["cross_attn_attn_gate"]).min() > 0
    assert np.abs(got["layers"]["xattn"]["cross_attn_mlp_gate"]).min() > 0


def test_remat_full_matches_none():
    """Vision and text ``remat="full"``: the loss and every gradient equal
    to ``"none"`` (only the backward's recompute differs)."""
    batch = _t(inputs())
    pix, ids, ar_ids, ar_mask, xmask = batch
    results = []
    for remat in ("none", "full"):
        cfg = port_config(JTINY, remat=remat)
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, remat=remat))
        model = M.MllamaForConditionalGeneration(cfg, device="cpu")
        model.load_state_dict(M.params_from_jax(jax_params(), cfg, device="cpu"))
        params = dict(model.named_parameters())
        loss = model.loss(ids, ids, pix, ar_ids, ar_mask, xmask)
        results.append((float(loss.detach()), torch.autograd.grad(loss, list(params.values()))))
    (l0, g0), (l1, g1) = results
    assert l0 == pytest.approx(l1, rel=1e-6)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("layout", ["regular", "irregular", "all cross"])
def test_group_pattern_and_layouts_match_jax(layout):
    """Regular (grouped stacks), irregular and all-cross configs (JAX's
    per-layer list, the port's ``layers.[i]``): the pattern, the layout
    and the logits against JAX's."""
    big = J.MLLAMA_CONFIGS["llama3.2-11b-vision"].text
    assert M.text_group_pattern(M.MLLAMA_CONFIGS["llama3.2-11b-vision"].text) == (8, 5, 3)
    assert J.text_group_pattern(big) == (8, 5, 3)
    text = {"regular": {}, "irregular": dict(cross_attention_layers=(1, 2)),
            "all cross": dict(num_hidden_layers=2, cross_attention_layers=(0, 1))}[layout]
    jcfg = dataclasses.replace(JTINY, text=dataclasses.replace(JTINY.text, **text))
    cfg = port_config(jcfg)
    assert M.text_group_pattern(cfg.text) == J.text_group_pattern(jcfg.text)
    p = jax_params(jcfg, seed=1)
    _, model = port_model(jcfg, params=p)
    names = {n for n, _ in model.named_parameters()}
    if layout == "regular":
        assert M.text_group_pattern(cfg.text) == (2, 2, 1)
        assert isinstance(p["layers"], dict)
        assert "layers.plain.mlp.gate_up" in names and "layers.xattn.mlp.gate_up" in names
        # the packed per-layer weights are the grouped leaves
        per_layer = [dict(_leaves(p["layers"]["xattn" if i % 2 else "plain"]))
                     for i in range(4)]
        per_layer = [{k: v[i // 2] if i % 2 else v[i // 2, 0] for k, v in d.items()}
                     for i, d in enumerate(per_layer)]
        packed = M._pack_text_layers(per_layer, (2, 2, 1))
        for kind in ("plain", "xattn"):
            for k, v in dict(_leaves(p["layers"][kind])).items():
                np.testing.assert_array_equal(packed[kind][k], v)
    else:
        assert isinstance(p["layers"], list)
        first = "cross_attn.q.kernel" if layout == "all cross" else "attn.qkv.q_kernel"
        assert "layers.[1].cross_attn.q.kernel" in names and f"layers.[0].{first}" in names
    batch = inputs(s=12)
    np.testing.assert_allclose(port_logits(model, batch), jax_logits(jcfg, p, batch),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["regular", "irregular"])
def test_params_bridge_bit_for_bit(layout):
    jcfg = JTINY if layout == "regular" else dataclasses.replace(
        JTINY, text=dataclasses.replace(JTINY.text, cross_attention_layers=(1, 2)))
    # JAX's own init: its tree's layout, every leaf
    p = with_gates(jax.jit(J.MllamaForConditionalGeneration(jcfg).init)(jax.random.key(2)))
    cfg, model = port_model(jcfg, params=p)
    back = M.params_to_jax(dict(model.named_parameters()), cfg)
    assert type(back["layers"]) is type(p["layers"])
    want, got = dict(_leaves(p)), dict(_leaves(back))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    # the stacked leaves are held whole, in their JAX shapes
    specs = model.param_specs()
    assert all(tuple(t.shape) == specs[n].shape for n, t in model.named_parameters())


@pytest.mark.parametrize("layout", ["regular", "irregular"])
def test_model_tags_cross_both_ways(tmp_path, layout):
    from neuronx_distributed_llama3_2_tpu.checkpoint import checkpoint as jckpt
    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import checkpoint as tckpt

    jcfg = JTINY if layout == "regular" else dataclasses.replace(
        JTINY, text=dataclasses.replace(JTINY.text, cross_attention_layers=(1, 2)))
    p = jax_params(jcfg, seed=3)
    cfg, model = port_model(jcfg, params=p)
    tckpt.save_checkpoint(str(tmp_path / "port"), "t", model=dict(model.named_parameters()))
    jckpt.save_checkpoint(str(tmp_path / "jax"), "t",
                          model=jax.tree.map(jnp.asarray, p))
    for kind in ("model.manifest.json",):
        assert ((tmp_path / "port" / "t" / kind).read_text()
                == (tmp_path / "jax" / "t" / kind).read_text())
    # the port's tag loads in JAX, JAX's in the port
    got = jckpt.load_checkpoint(str(tmp_path / "port"), "t", model=jax.tree.map(jnp.asarray, p))
    got = got[0] if isinstance(got, tuple) else got
    for k, v in dict(_leaves(p)).items():
        np.testing.assert_array_equal(np.asarray(dict(_leaves(_model_of(got)))[k]), v)
    fresh = M.MllamaForConditionalGeneration(cfg, device="cpu")
    loaded = tckpt.load_checkpoint(str(tmp_path / "jax"), "t",
                                   model=dict(fresh.named_parameters()))
    loaded = _model_of(loaded[0] if isinstance(loaded, tuple) else loaded)
    for n, t in model.named_parameters():
        assert torch.equal(loaded[n], t.detach()), n


def _model_of(x):
    return x["model"] if isinstance(x, dict) and "model" in x else x


def test_bf16_forward_and_image_witness():
    """bf16 logits within BF16_BAND of fp32 on the same weights; a second
    image moves the fp32 logits by more than the band (the seeded gates let
    the image through)."""
    batch = inputs()
    _, f32 = port_model()
    jbf = dataclasses.replace(
        JTINY, vision=dataclasses.replace(JTINY.vision, dtype=jnp.bfloat16),
        text=dataclasses.replace(JTINY.text, dtype=jnp.bfloat16))
    _, bf = port_model(jbf, params=jax_params())
    ref = port_logits(f32, batch)
    gap = np.abs(port_logits(bf, batch) - ref).max()
    assert gap <= BF16_BAND, gap
    other = list(batch)
    other[0] = np.random.default_rng(5).standard_normal(batch[0].shape).astype(np.float32)
    moved = np.abs(port_logits(f32, other) - ref)
    assert moved.max() > BF16_BAND, moved.max()


def test_registry_and_script_refusals():
    from neuronx_distributed_llama3_2_tpu_torch.models import resolve_model

    entry = resolve_model("llama3.2-11b-vision")
    assert entry["model_cls"] is M.MllamaForConditionalGeneration
    assert entry["config"] is M.MLLAMA_CONFIGS["llama3.2-11b-vision"]
    assert resolve_model("tiny-mllama")["config"].text.vocab_size == 128
    assert tllama.param_specs(M.MLLAMA_CONFIGS["tiny-mllama"]).keys() == M.param_specs(
        M.MLLAMA_CONFIGS["tiny-mllama"]).keys()


def test_cross_attention_refuses_split_heads(monkeypatch):
    """A tp that does not divide the cross layers' kv heads (JAX's GSPMD
    would split a head; the port holds whole heads) raises at
    construction, naming them."""
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as pstate

    monkeypatch.setattr(pstate, "tensor_parallel_size_or", lambda default=1: 4)
    monkeypatch.setattr(pstate, "tensor_parallel_rank_or", lambda default=0: 0)
    with pytest.raises(ValueError, match="2 kv heads of the cross attention"):
        M.TextCrossAttention(port_config(JTINY).text, device="meta")
