"""The port's MoE modules (moe/) against the JAX package's, on the CPU, in
fp32.

The same numpy weights and inputs go through both: the routers (top-k and
Sinkhorn, k = 1 and 2), the load-balancing loss, each dispatch path of
``ExpertMLPs`` (all experts, selective, capacity with and without drops),
``dispatch`` / ``combine`` themselves, the dispatch rule, and the ``MoE``
block's output and gradients against ``jax.grad``.

The inputs are normal draws, so no two router logits of a token tie:
``torch.topk`` and ``lax.top_k`` order tied values differently, and on
inputs without ties they pick the same experts. Tolerances: the same fp32
math in another order, 1e-5 (relative and absolute) on outputs, 1e-5 on
gradients; expert indices, slots and keep masks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.moe import experts as jex
from neuronx_distributed_llama3_2_tpu.moe import loss as jloss
from neuronx_distributed_llama3_2_tpu.moe import model as jmoe
from neuronx_distributed_llama3_2_tpu.moe import routing as jrt
from neuronx_distributed_llama3_2_tpu_torch.moe import experts as tex
from neuronx_distributed_llama3_2_tpu_torch.moe import loss as tloss
from neuronx_distributed_llama3_2_tpu_torch.moe import model as tmoe
from neuronx_distributed_llama3_2_tpu_torch.moe import routing as trt

torch.set_num_threads(1)

E, H, I = 8, 16, 32
TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _logits(t, e=E, seed=0):
    return _rng(seed).standard_normal((t, e)).astype(np.float32)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("k", [1, 2])
def test_top_k_routing_matches_jax(k, normalize):
    logits = _logits(12)
    jg, ji = jrt.top_k_routing(jnp.asarray(logits), k, normalize)
    tg, ti = trt.top_k_routing(_t(logits), k, normalize)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), _np(jg), **TOL)
    assert tg.dtype == torch.float32


@pytest.mark.parametrize("k", [1, 2])
def test_sinkhorn_routing_matches_jax(k):
    """k = 1 gates by sigmoid(logit); k = 2 by the renormalized softmax."""
    logits = _logits(10, seed=3)
    np.testing.assert_allclose(trt.sinkhorn(_t(logits), 3).numpy(),
                               _np(jrt.sinkhorn(jnp.asarray(logits), 3)), **TOL)
    jg, ji = jrt.sinkhorn_routing(jnp.asarray(logits), k, 3, True)
    tg, ti = trt.sinkhorn_routing(_t(logits), k, 3, True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), _np(jg), **TOL)
    if k == 1:
        np.testing.assert_allclose(
            tg.numpy(), 1 / (1 + np.exp(-np.take_along_axis(logits, ti.numpy(), 1))), **TOL)


def test_router_and_load_balancing_loss_match_jax():
    x = _rng(1).standard_normal((12, H)).astype(np.float32)
    jr = jrt.Router(H, E)
    jp = jr.init(jax.random.key(0))
    tr = trt.Router(H, E)
    with torch.no_grad():
        tr.kernel.copy_(_t(jp["kernel"]))
    logits = tr(_t(x))
    np.testing.assert_allclose(logits.detach().numpy(), _np(jr(jp, jnp.asarray(x))), **TOL)
    _, idx = trt.top_k_routing(logits.detach(), 2)
    want = jloss.load_balancing_loss(jnp.asarray(logits.detach().numpy()),
                                     jnp.asarray(idx.numpy(), jnp.int32), E)
    got = tloss.load_balancing_loss(logits.detach(), idx, E)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _experts(cf=None, glu=True, seed=0):
    j = jex.ExpertMLPs(num_experts=E, hidden_size=H, intermediate_size=I, capacity_factor=cf,
                       glu=glu, dtype=jnp.float32)
    p = j.init(jax.random.key(seed))
    t = tex.ExpertMLPs(E, H, I, capacity_factor=cf, glu=glu, dtype=torch.float32)
    with torch.no_grad():
        t.gate_up.copy_(_t(p["gate_up"]))
        t.down.copy_(_t(p["down"]))
    return j, p, t


def _route(t, k=2, seed=2):
    x = _rng(seed).standard_normal((t, H)).astype(np.float32)
    gates, idx = trt.top_k_routing(_t(_logits(t, seed=seed + 10)), k)
    return x, gates, idx


@pytest.mark.parametrize("path", ["all_experts", "selective", "capacity_1", "capacity_0.5"])
def test_expert_paths_match_jax(path):
    cf = float(path.split("_")[1]) if path.startswith("capacity") else None
    j, p, t = _experts(cf)
    x, gates, idx = _route(11)
    jx, jg, ji = jnp.asarray(x), jnp.asarray(gates.numpy()), jnp.asarray(idx.numpy(), jnp.int32)
    fn = {"all_experts": "forward_all_experts", "selective": "forward_selective"}.get(
        path, "forward_capacity_factor")
    want = getattr(j, fn)(p, jx, jg, ji)
    got = getattr(t, fn)(_t(x), gates, idx)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)


def test_dispatch_and_combine_match_jax_with_drops():
    """cf 0.5: C = ceil(T·k·0.5 / E) slots, the later tokens of a crowded
    expert dropped to the dummy slot E·C; the slots, the keep mask and the
    buffers equal JAX's, and the combine too."""
    j, p, t = _experts(0.5)
    x, gates, idx = _route(24)
    cap = t.capacity(24, 2)
    assert cap == j.capacity(24, 2) == 3
    jbuf, jslot, jkeep = j.dispatch(jnp.asarray(x), jnp.asarray(gates.numpy()),
                                    jnp.asarray(idx.numpy(), jnp.int32), cap)
    buf, slot, keep = t.dispatch(_t(x), gates, idx, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert keep.sum() < keep.numel()  # some assignments dropped
    np.testing.assert_allclose(buf.numpy(), _np(jbuf), **TOL)
    y = _rng(5).standard_normal(tuple(buf.shape)).astype(np.float32)
    want = j.combine(jnp.asarray(y), jslot, jkeep, jnp.asarray(gates.numpy()), 24)
    got = t.combine(_t(y), slot, keep, gates, 24)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("tokens,selective", [(1, True), (2, True), (4, True), (5, False)])
def test_dispatch_rule_matches_jax(tokens, selective, monkeypatch):
    """Without a capacity factor: selective exactly when T·k <= E (JAX
    ``__call__``), and the output of the path taken equals JAX's."""
    j, p, t = _experts()
    x, gates, idx = _route(tokens)
    calls = []
    inner = tex.ExpertMLPs.forward_selective
    monkeypatch.setattr(tex.ExpertMLPs, "forward_selective",
                        lambda self, *a: (calls.append(1), inner(self, *a))[1])
    got = t(_t(x), gates, idx)
    assert bool(calls) == selective
    assert t.path(tokens, 2) == ("selective" if selective else "all_experts")
    want = j(p, jnp.asarray(x), jnp.asarray(gates.numpy()), jnp.asarray(idx.numpy(), jnp.int32))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)


def _moe_pair(routing, cf, k=2, glu=True):
    jc = jmoe.MoEConfig(hidden_size=H, intermediate_size=I, num_experts=E, top_k=k,
                        capacity_factor=cf, routing=routing, glu=glu, dtype=jnp.float32)
    jm = jmoe.MoE(jc)
    p = jm.init(jax.random.key(4))
    tc = tmoe.MoEConfig(hidden_size=H, intermediate_size=I, num_experts=E, top_k=k,
                        capacity_factor=cf, routing=routing, glu=glu, dtype=torch.float32)
    tm = tmoe.MoE(tc)
    with torch.no_grad():
        tm.router.kernel.copy_(_t(p["router"]["kernel"]))
        tm.experts.gate_up.copy_(_t(p["experts"]["gate_up"]))
        tm.experts.down.copy_(_t(p["experts"]["down"]))
    return jm, p, tm


@pytest.mark.parametrize("routing,cf,k", [
    ("topk", None, 2), ("topk", 1.0, 2), ("topk", 0.5, 2), ("sinkhorn", None, 2),
    ("sinkhorn", 1.25, 1),
])
def test_moe_block_output_and_grads_match_jax(routing, cf, k):
    """(y, router_logits, expert_idx) of the block and the gradients of
    sum(y · w) + the aux loss by every weight and by x, against jax.grad."""
    jm, p, tm = _moe_pair(routing, cf, k)
    x = _rng(8).standard_normal((2, 6, H)).astype(np.float32)
    w = _rng(9).standard_normal((2, 6, H)).astype(np.float32)

    def jloss_fn(p, x):
        y, logits, idx = jm(p, x)
        return jnp.sum(y * w) + jloss.load_balancing_loss(logits, idx, E)

    (jy, jlogits, jidx) = jm(p, jnp.asarray(x))
    jval, (jgp, jgx) = jax.value_and_grad(jloss_fn, argnums=(0, 1))(p, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y, logits, idx = tm(xt)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(logits.detach().numpy(), _np(jlogits), **TOL)
    val = (y * _t(w)).sum() + tloss.load_balancing_loss(logits, idx, E)
    params = [tm.router.kernel, tm.experts.gate_up, tm.experts.down, xt]
    grads = torch.autograd.grad(val, params)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    for g, want in zip(grads, (jgp["router"]["kernel"], jgp["experts"]["gate_up"],
                               jgp["experts"]["down"], jgx)):
        np.testing.assert_allclose(g.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_moe_config_checks_match_jax():
    for kw in (dict(routing="nope"), dict(top_k=0), dict(top_k=E + 1)):
        with pytest.raises(ValueError):
            jmoe.MoEConfig(hidden_size=H, intermediate_size=I, num_experts=E, **kw)
        with pytest.raises(ValueError):
            tmoe.MoEConfig(hidden_size=H, intermediate_size=I, num_experts=E, **kw)


def test_ep_forward_refuses_no_capacity_factor(monkeypatch):
    """ep > 1 without a capacity factor raises, as JAX's does."""
    _, _, tm = _moe_pair("topk", None)
    monkeypatch.setattr(tm.experts, "ep", 2)
    with pytest.raises(ValueError, match="requires a capacity_factor"):
        tm(torch.zeros((1, 4, H)))
