"""The port's front door (``serving/server.py``, ``GraftServer``) against the
JAX package's, on the CPU at the tiny config (fp32) with the same weights.

The counterparts of the JAX package's tests/test_server.py: concurrent
asyncio clients stream exactly the tokens the batch path commits, a
client cancel fails only its request, the hand-written HTTP/1.1 transport
round-trips completions (plain and SSE), lookups, cancels and both scrape
endpoints, and a prewarmed SLO-scheduled engine keeps its steady steps
upload-free. Each scenario runs through both packages' servers, and the
port's completion payloads must equal the JAX server's field by field,
apart from the timings.
"""

import asyncio
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.inference import (
    GenerationConfig as JaxGenerationConfig,
    InferenceEngine as JaxInferenceEngine,
)
from neuronx_distributed_llama3_2_tpu.models.llama import (
    LLAMA_CONFIGS as JAX_CONFIGS,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_llama3_2_tpu.serving import (
    GraftServer as JaxGraftServer,
    PagedConfig as JaxPagedConfig,
    PagedServingEngine as JaxPagedServingEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
    GenerationConfig,
    InferenceEngine,
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
from neuronx_distributed_llama3_2_tpu_torch.serving.invariants import audit_engine
from neuronx_distributed_llama3_2_tpu_torch.serving.server import GraftServer

torch.set_num_threads(1)

JAX_TINY = dataclasses.replace(JAX_CONFIGS["tiny"], use_paged_kernel=True)
TINY = dataclasses.replace(LLAMA_CONFIGS["tiny"], use_paged_kernel=True)
ENGINE_KW = dict(max_batch=4, max_seq_len=64, buckets=[8, 16, 32])
#: the decoder layers' kernels scaled from the init (as in
#: tests/test_torch_faults.py): at the init scale every greedy stream
#: repeats one token, which would hide a token committed one step off
LAYER_SCALE = 10.0


def _scaled(path, x):
    name = jax.tree_util.keystr(path)
    return x * LAYER_SCALE if "layers" in name and "scale" not in name else x


@pytest.fixture(scope="module")
def weights():
    """(JAX pytree, port module) holding the same seeded weights."""
    jp = jax.tree_util.tree_map_with_path(
        _scaled, JaxLlama(JAX_TINY).init(jax.random.key(0))
    )
    model = LlamaForCausalLM(TINY, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), TINY, device="cpu"))
    return jp, model


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY.vocab_size, size=(n,)).tolist() for n in lengths]


def _engines(weights, max_new, port_knobs=(), **paged):
    """(JAX server class and engine, port server class and engine); the
    port's engine takes ``port_knobs`` on top of ``paged``."""
    jp, model = weights
    jax_eng = JaxPagedServingEngine(
        JaxInferenceEngine(JAX_TINY, jp, **ENGINE_KW),
        JaxGenerationConfig(max_new_tokens=max_new), JaxPagedConfig(**paged), precompile=False,
    )
    port = PagedServingEngine(
        InferenceEngine(TINY, model, **ENGINE_KW), GenerationConfig(max_new_tokens=max_new),
        PagedConfig(**paged, **dict(port_knobs)),
    )
    return (JaxGraftServer, jax_eng), (GraftServer, port)


def _untimed(payload):
    """A completion payload without its timings (their keys kept)."""
    out = dict(payload)
    out["timing"] = sorted(out["timing"])
    return out


def _audit(eng):
    assert eng._pending is None
    assert eng.allocator.active_blocks == 0
    assert eng.allocator.leak_check() == []


def test_streamed_tokens_match_batch_run(weights):
    """Concurrent streaming clients receive exactly the tokens the batch
    path commits; responses carry usage and a TTFT; no stream stays open
    (JAX: test_streamed_tokens_match_batch_run)."""
    cfg = dict(block_size=8, num_blocks=64, prefill_chunk_tokens=8, async_loop=True,
               step_policy="slo")
    prompts = _prompts(7, (5, 12, 20, 9, 17))
    batch = PagedServingEngine(
        InferenceEngine(TINY, weights[1], **ENGINE_KW), GenerationConfig(max_new_tokens=6),
        PagedConfig(**cfg),
    )
    for p in prompts:
        batch.submit(p)
    expected = batch.run_to_completion()

    def serve(server_cls, eng):
        got, responses = {}, {}

        async def client(srv, i, prompt):
            sc = "interactive" if i % 2 else "batch"
            rid = srv.submit(prompt, service_class=sc, tenant=f"t{i % 2}")
            got[rid] = [t async for t in srv.stream(rid)]
            responses[rid] = srv.response(rid)

        async def main():
            async with server_cls(eng, idle_poll_s=0.002) as srv:
                await asyncio.gather(*(client(srv, i, p) for i, p in enumerate(prompts)))
                return srv.snapshot()

        return got, responses, asyncio.run(main())

    (jax_cls, jax_eng), (port_cls, port) = _engines(weights, 6, **cfg)
    j_got, j_resp, j_snap = serve(jax_cls, jax_eng)
    got, responses, snap = serve(port_cls, port)
    assert got == expected == j_got
    assert {r: _untimed(p) for r, p in responses.items()} == {
        r: _untimed(p) for r, p in j_resp.items()}
    for rid, resp in responses.items():
        assert resp["status"] == "finished" and resp["error"] is None
        assert resp["choices"][0]["token_ids"] == expected[rid]
        assert resp["choices"][0]["finish_reason"] in ("length", "stop")
        assert resp["usage"]["completion_tokens"] == len(expected[rid])
        assert resp["usage"]["prompt_tokens"] == len(prompts[rid])
        assert resp["timing"]["ttft_ms"] is not None
    for key in ("active_streams", "finished", "requests_by_class"):
        assert snap[key] == j_snap[key], key
    assert snap["active_streams"] == 0 and snap["finished"] == len(prompts)
    assert snap["requests_by_class"]["interactive"]["finished"] == 2
    assert snap["requests_by_class"]["batch"]["finished"] == 3
    _audit(port)
    assert audit_engine(port) == []


def test_cancel_mid_stream(weights):
    """A client cancel mid-decode closes the stream with a structured
    ``cancelled`` payload and leaves the survivor's stream equal to an
    uncancelled engine's (JAX: test_cancel_mid_stream)."""
    cfg = dict(block_size=8, num_blocks=64, async_loop=True)
    prompts = _prompts(9, (6, 10))
    solo = PagedServingEngine(
        InferenceEngine(TINY, weights[1], **ENGINE_KW), GenerationConfig(max_new_tokens=12),
        PagedConfig(**cfg),
    )
    for p in prompts:
        solo.submit(p)
    baseline = solo.run_to_completion()

    def serve(server_cls, eng):
        async def main():
            async with server_cls(eng, idle_poll_s=0.002) as srv:
                victim = srv.submit(prompts[0])
                survivor = srv.submit(prompts[1])

                async def stream_victim():
                    toks = []
                    async for t in srv.stream(victim):
                        toks.append(t)
                        if len(toks) == 2:
                            assert srv.cancel(victim) is True
                    return toks

                async def stream_survivor():
                    return [t async for t in srv.stream(survivor)]

                v_toks, s_toks = await asyncio.gather(stream_victim(), stream_survivor())
                assert srv.cancel(victim) is False  # idempotent once terminal
                return (v_toks, s_toks, srv.response(victim), srv.response(survivor),
                        srv.snapshot())

        return asyncio.run(main())

    (jax_cls, jax_eng), (port_cls, port) = _engines(weights, 12, **cfg)
    j_v, j_s, j_vresp, j_sresp, _ = serve(jax_cls, jax_eng)
    v_toks, s_toks, v_resp, s_resp, snap = serve(port_cls, port)
    assert (v_toks, s_toks) == (j_v, j_s)
    assert _untimed(v_resp) == _untimed(j_vresp) and _untimed(s_resp) == _untimed(j_sresp)
    assert s_toks == baseline[1]
    assert v_toks == baseline[0][: len(v_toks)] and len(v_toks) < len(baseline[0])
    assert v_resp["status"] == "failed" and v_resp["error"]["type"] == "cancelled"
    assert v_resp["choices"][0]["finish_reason"] == "cancelled"
    assert snap["cancelled_requests"] == 1 and snap["active_streams"] == 0
    _audit(port)


async def _http(host, port, method, target, body=None):
    """One request over a fresh connection (``Connection: close``):
    (status, body bytes)."""
    reader, writer = await asyncio.open_connection(host, port)
    payload = b"" if body is None else json.dumps(body).encode()
    writer.write(
        f"{method} {target} HTTP/1.1\r\nHost: {host}\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), data


def _sse_events(data):
    return [json.loads(line[len("data: "):]) for line in data.decode().split("\n\n")
            if line.startswith("data: ") and line != "data: [DONE]"]


def test_http_transport_roundtrips(weights):
    """The HTTP loop: plain and SSE completions, request lookup, the
    cancel route, both scrape endpoints and 404s, one loopback connection
    a request (JAX: test_http_transport_roundtrips)."""
    prompt = _prompts(4, (7,))[0]

    def serve(server_cls, eng):
        async def main():
            srv = server_cls(eng, idle_poll_s=0.002)
            host, port = await srv.serve_http()
            seen = {}
            try:
                seen["plain"] = await _http(host, port, "POST", "/v1/completions", {
                    "prompt": prompt, "service_class": "interactive", "tenant": "acme"})
                seen["sse"] = await _http(host, port, "POST", "/v1/completions",
                                          {"prompt": prompt, "stream": True})
                seen["lookup"] = await _http(host, port, "GET", "/v1/requests/0")
                seen["cancel"] = await _http(host, port, "POST", "/v1/requests/0/cancel")
                seen["lookup 99"] = await _http(host, port, "GET", "/v1/requests/99")
                seen["cancel 99"] = await _http(host, port, "POST", "/v1/requests/99/cancel")
                seen["nope"] = await _http(host, port, "GET", "/nope")
                seen["snapshot"] = await _http(host, port, "GET", "/snapshot")
                seen["metrics"] = await _http(host, port, "GET", "/metrics")
            finally:
                await srv.close()
            return seen

        return asyncio.run(main())

    (jax_cls, jax_eng), (port_cls, port) = _engines(
        weights, 5, block_size=8, num_blocks=64, async_loop=True)
    want, got = serve(jax_cls, jax_eng), serve(port_cls, port)
    assert {k: s for k, (s, _) in got.items()} == {k: s for k, (s, _) in want.items()} == {
        "plain": 200, "sse": 200, "lookup": 200, "cancel": 200, "lookup 99": 404,
        "cancel 99": 404, "nope": 404, "snapshot": 200, "metrics": 200}
    for name in ("plain", "lookup"):
        assert _untimed(json.loads(got[name][1])) == _untimed(json.loads(want[name][1]))
    resp = json.loads(got["plain"][1])
    assert resp["status"] == "finished" and resp["service_class"] == "interactive"
    assert resp["tenant"] == "acme" and json.loads(got["lookup"][1])["id"] == "cmpl-0"
    first = resp["choices"][0]["token_ids"]
    assert len(first) == 5
    events = _sse_events(got["sse"][1])
    assert "data: [DONE]" in got["sse"][1].decode()
    toks = [e["token"] for e in events if "token" in e]
    final = [e for e in events if "choices" in e][-1]
    assert final["choices"][0]["token_ids"] == toks == first
    assert _untimed(final) == _untimed([e for e in _sse_events(want["sse"][1])
                                        if "choices" in e][-1])
    assert json.loads(got["cancel"][1]) == {"rid": 0, "cancelled": False}
    snap = json.loads(got["snapshot"][1])
    assert snap["finished"] == 2 and "requests_by_class" in snap
    text = got["metrics"][1].decode()
    assert "serving_finished 2" in text
    assert 'serving_info{kv_dtype="' in text
    assert 'serving_requests_class{class="interactive"' in text
    _audit(port)


def test_slo_steady_state_resident_under_prewarm(weights):
    """The SLO policy does not tax the device path: on a prewarmed async
    engine a steady decode step uploads nothing, syncs no lane and writes
    no table entry, and nothing is registered after the freeze; the
    stream equals the JAX engine's (JAX:
    test_slo_steady_state_resident_under_prewarm)."""
    knobs = dict(block_size=32, num_blocks=8, async_loop=True, step_policy="slo",
                 slo_ttft_p99_ms=50.0, slo_tpot_p99_ms=10_000.0, slo_eval_steps=8)
    (_, jax_eng), (_, port) = _engines(weights, 24, port_knobs=dict(prewarm=True), **knobs)
    prompt = _prompts(0, (4,))[0]
    rids = [eng.submit(prompt, service_class="interactive", tenant="acme")
            for eng in (jax_eng, port)]
    port.step()  # admission and prefill
    port.step()  # the first async dispatch flushes the dirty lane
    m = port.metrics
    for _ in range(12):
        before = (m.h2d_uploads, m.lane_syncs, m.table_deltas)
        assert port.step()
        assert (m.h2d_uploads, m.lane_syncs, m.table_deltas) == before
    assert port.run_to_completion()[rids[1]] == jax_eng.run_to_completion()[rids[0]]
    assert m.prewarm_compiles > 0 and m.steadystate_compiles == 0
    _audit(port)
    assert audit_engine(port) == []
