"""Mllama and the channel-parallel convs over four gloo ranks (tp 2 x dp
2), against the JAX package on one device, in fp32: one spawn
(``tests/torch_dist_workers.py`` ``mllama_worker``) that holds

- the conv layers at tp = 2 (JAX ``tests/test_conv.py``'s cases: the
  gathered output-channel layer, the output -> input pair with its
  intermediate split over tp, the pair's gradients gathered whole);
- the tiny Mllama (``tests/test_torch_mllama.py``'s weights, gates
  seeded) at tp = 2 with SP off and on: logits, loss and every gradient
  leaf gathered whole;
- the indivisible-vocab fallbacks (vocab 125 at tp 2: the embedding's
  133 rows split on its dim, the head row-parallel with whole logits),
  logits and loss under SP;
- one ZeRO-1 AdamW step through ``initialize_parallel_model`` /
  ``make_train_step`` (SP on, the image inputs as batch entries) against
  JAX's ``model.loss`` + ``apply_gradients`` + ``default_weight_decay_mask``
  (its ``_dryrun_mllama`` step); the step's tag, saved at tp 2 x dp 2,
  loads in JAX, and JAX's tag of its step loads at tp 2 x dp 2.

Tolerances as ``tests/test_torch_mllama.py`` (conv: JAX's 1e-5 / 1e-4);
after the AdamW step, parameters within 2·lr at most and 1e-6 on the
mean (a step that moved nothing, or a rank that kept the old values of
the parts it does not update, sits about lr off), and moments within
1e-5 of their leaf's scale; tags bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from neuronx_distributed_llama3_2_tpu.checkpoint import checkpoint as jckpt
from neuronx_distributed_llama3_2_tpu.models import mllama as J
from neuronx_distributed_llama3_2_tpu.parallel import conv as jconv
from neuronx_distributed_llama3_2_tpu.trainer import optimizer as jopt
from neuronx_distributed_llama3_2_tpu.trainer.config import OptimizerConfig as JOptimizerConfig
from neuronx_distributed_llama3_2_tpu.trainer.trainer import default_weight_decay_mask

from tests.test_torch_conv import nudged, x_of
from tests.test_torch_mllama import (
    JTINY,
    _leaves,
    assert_grads,
    inputs,
    jax_params,
    port_config,
)

LR = 1e-3
OPT_KW = dict(zero_one_enabled=True, warmup_steps=1, learning_rate=LR)


def _conv_inputs():
    one = jconv.OutputChannelParallelConv2d(16, 32, kernel_size=3, padding=1, gather_output=True)
    p_one = nudged(one.init(jax.random.key(0)), 0)
    c1 = jconv.OutputChannelParallelConv2d(16, 32, kernel_size=3, padding=1)
    c2 = jconv.InputChannelParallelConv2d(32, 8, kernel_size=1)
    p1, p2 = nudged(c1.init(jax.random.key(1)), 1), nudged(c2.init(jax.random.key(2)), 2)
    g1 = jconv.OutputChannelParallelConv2d(8, 16, kernel_size=3, padding=1)
    g2 = jconv.InputChannelParallelConv2d(16, 4, kernel_size=1)
    q1, q2 = nudged(g1.init(jax.random.key(3)), 3), nudged(g2.init(jax.random.key(4)), 4)
    x, gx = x_of(), x_of(b=4, c=8, seed=5)

    def loss(q1, q2, x):
        return jnp.sum(g2(q2, g1(q1, x)) ** 2)

    grads = jax.grad(loss, argnums=(0, 1, 2))(q1, q2, jnp.asarray(gx))
    want = dict(one=np.asarray(one(p_one, jnp.asarray(x))),
                pair=np.asarray(c2(p2, c1(p1, jnp.asarray(x)))), grads=grads)
    return dict(x=x, gx=gx, one=p_one, c1=p1, c2=p2, g1=q1, g2=q2), want


def _batch(jb):
    pix, ids, ar_ids, ar_mask, xmask = jb
    return dict(ids=ids, pix=pix, ar_ids=ar_ids, ar_mask=ar_mask, xmask=xmask)


def _train_batch():
    """Four rows (two a dp rank), both aspect ratios on each rank."""
    pix, ids, ar_ids, ar_mask, xmask = inputs(b=2, s=16)
    pix2, ids2, _, _, xmask2 = inputs(seed=1, b=2, s=16)
    xmask2[:, :8] = 0
    return (np.concatenate([pix, pix2]), np.concatenate([ids, ids2]),
            np.concatenate([ar_ids, ar_ids[::-1]]), np.concatenate([ar_mask, ar_mask[::-1]]),
            np.concatenate([xmask, xmask2]))


def _jax_call(jcfg, p, b, loss_too=True):
    pix, ids, ar, arm, xm = (jnp.asarray(a) for a in b)
    m = J.MllamaForConditionalGeneration(jcfg)
    logits = np.asarray(jax.jit(m.__call__)(p, ids, pix, ar, arm, xm))
    if not loss_too:
        return logits
    loss, grads = jax.jit(jax.value_and_grad(
        lambda q: m.loss(q, ids, ids, pix, ar, arm, xm)))(p)
    return logits, float(loss), jax.tree.map(np.asarray, grads)


def test_mllama_and_convs_over_tp2_dp2(tmp_path):
    from tests import torch_dist_workers as W

    conv_in, conv_want = _conv_inputs()
    p = jax_params()
    batch = inputs()
    logits, loss, grads = _jax_call(JTINY, p, batch)
    # vocab 125: both tables trimmed, the ids kept below it
    j125 = dataclasses.replace(JTINY, text=dataclasses.replace(JTINY.text, vocab_size=125))
    p125 = dict(p, embed={"embedding": p["embed"]["embedding"][:133]},
                lm_head={"kernel": p["lm_head"]["kernel"][:, :125]})
    b125 = list(batch)
    b125[1] = np.minimum(batch[1], 124)
    logits125, loss125, _ = _jax_call(j125, p125, b125)
    # JAX's step (_dryrun_mllama's): model.loss + apply_gradients, one device
    tb = _train_batch()
    _, tloss, tgrads = _jax_call(JTINY, p, tb)
    jcfg = JOptimizerConfig(**OPT_KW)
    jp = jax.tree.map(jnp.asarray, p)
    new_p, new_opt, gnorm = jopt.apply_gradients(
        jopt.init_optimizer_state(jp, jcfg), jax.tree.map(jnp.asarray, tgrads), jp, jcfg,
        weight_decay_mask=default_weight_decay_mask(jp))
    jax_root = str(tmp_path / "jax")
    jckpt.save_checkpoint(jax_root, "step_1", model=new_p, optimizer=new_opt)
    cfg = port_config(JTINY)
    out = W.run(W.mllama_worker, 4, tmp_path, dict(
        conv=conv_in, cfg=cfg, params=p, batch=_batch(batch), params125=p125,
        batch125=_batch(b125), opt_kw=OPT_KW, train_batch=_batch(tb),
        port_root=str(tmp_path / "port"), jax_root=jax_root))
    for rank in out:
        got = rank["conv tp2"]
        np.testing.assert_allclose(got["one"], conv_want["one"], atol=1e-5)
        np.testing.assert_allclose(got["pair"], conv_want["pair"], atol=1e-5)
        assert got["mid_channels"] == 16  # the intermediate is split over tp
        for g, w in ((got["g1"], conv_want["grads"][0]), (got["g2"], conv_want["grads"][1])):
            for k in ("kernel", "bias"):
                np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=1e-4)
        np.testing.assert_allclose(got["gx"], np.asarray(conv_want["grads"][2]), atol=1e-4)
        for sp in (False, True):
            got = rank[f"mllama tp2 sp={sp}"]
            assert got["sequence_parallel"] == sp
            np.testing.assert_allclose(got["logits"], logits, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
            assert_grads(got["grads"], grads)
        got = rank["mllama tp2 vocab125"]
        assert got["embed_spec"] == (None, "tp") and got["head_spec"] == ("tp", None)
        assert not got["head_is_column"]
        np.testing.assert_allclose(got["logits"], logits125, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["loss"], loss125, rtol=1e-5)
        got = rank["mllama tp2 dp2 zero1"]
        assert got["dp_split"], "ZeRO-1 split no optimizer leaf over dp"
        np.testing.assert_allclose(got["loss"], tloss, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], float(gnorm), rtol=1e-4)
        want_p = dict(_leaves(jax.tree.map(np.asarray, new_p)))
        for k, v in dict(_leaves(got["params"])).items():
            diff = np.abs(v - want_p[k])
            assert diff.max() <= 2 * LR and diff.mean() <= 1e-6, k
        for field in ("mu", "nu"):
            want = dict(_leaves(jax.tree.map(np.asarray, getattr(new_opt, field))))
            for k, v in dict(_leaves(getattr(got["opt"], field))).items():
                assert np.abs(v - want[k]).max() <= 1e-5 * max(np.abs(want[k]).max(), 1e-6), \
                    (field, k)
        # JAX's tag loaded at tp 2 x dp 2: its step's state, bit for bit
        for k, v in dict(_leaves(got["jax_tag"]["params"])).items():
            np.testing.assert_array_equal(v, want_p[k])
        want_mu = dict(_leaves(jax.tree.map(np.asarray, new_opt.mu)))
        for k, v in dict(_leaves(got["jax_tag"]["opt"].mu)).items():
            np.testing.assert_array_equal(v, want_mu[k])
    # the port's tag of its step, saved at tp 2 x dp 2, loads in JAX
    tag = jckpt.load_checkpoint(str(tmp_path / "port"), "step_1", model=new_p,
                                optimizer=new_opt)
    port_p = dict(_leaves(out[0]["mllama tp2 dp2 zero1"]["params"]))
    for k, v in dict(_leaves(jax.tree.map(np.asarray, tag["model"]))).items():
        np.testing.assert_array_equal(v, port_p[k])
    port_nu = dict(_leaves(out[0]["mllama tp2 dp2 zero1"]["opt"].nu))
    for k, v in dict(_leaves(jax.tree.map(np.asarray, tag["optimizer"].nu))).items():
        np.testing.assert_array_equal(v.astype(np.float32), port_nu[k])
