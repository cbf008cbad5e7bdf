"""The port's generation path on the CPU (incubator_mxnet_tpu_torch/
ops/kvcache.py and serving/generate.py) against the JAX package's.

- The KV functions against the JAX ones on the same pools and data:
  ``write_seq``, ``append_token`` and ``gather_layer`` bit for bit in
  fp32, every pool byte outside the live blocks untouched (the port's
  out-of-range writes land in the pool's private block, the JAX
  package's are dropped); ``paged_attention`` within 1e-6 (fp32 sums
  in another order) and against a dense numpy reference.
- Greedy tokens from the port's ``GenerativeEngine`` equal the JAX
  engine's for the same ``TinyLM`` weights and prompts
  (``convert.tinylm_from_jax``).
- Continuous batching equals ``generate_sequential`` token for token
  under join and leave, greedy and sampled; the sampler draws from the
  top-k-masked temperature softmax and a row's draw does not depend on
  its batch; ``numeric_error`` retirement frees the row's blocks.
- Through the CPU stand-in for the CUDA graph (tests/test_torch_aot.py's
  ``CpuCapture``), ``warm()`` captures every program and steady-state
  decode captures nothing, with the same tokens as the eager engine.
- The streaming HTTP front end: 8 concurrent clients, one hanging up
  mid-stream; the error contract of ``POST /generate``.

Every wait and socket read is bounded; engines are closed in ``finally``.
"""
import http.client
import json
import threading
import time

import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu.ops import kvcache as jkv
from incubator_mxnet_tpu.serving import generate as jgen

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import jit as tjit
from incubator_mxnet_tpu_torch import telemetry
from incubator_mxnet_tpu_torch.ops import kvcache
from incubator_mxnet_tpu_torch.serving import generate as gen
from incubator_mxnet_tpu_torch.serving import accesslog
from incubator_mxnet_tpu_torch.serving.registry import ModelRegistry
from incubator_mxnet_tpu_torch.serving.server import ServingServer
from incubator_mxnet_tpu_torch.telemetry import flightrec, spans

from test_torch_aot import cpu_graphs  # noqa: F401 — a fixture

GEO = dict(block_size=8, num_blocks=48, max_batch=4, prefill_len=16,
           max_tokens=16)

MIXED = [
    {"prompt": [3, 5, 8], "max_new_tokens": 12, "seed": 7,
     "temperature": 0.8, "top_k": 40},
    {"prompt": [200, 4], "max_new_tokens": 5, "seed": 1},
    {"prompt": list(range(1, 14)), "max_new_tokens": 9, "seed": 9,
     "temperature": 1.3, "top_k": 3},
    {"prompt": [42], "max_new_tokens": 16, "seed": 3,
     "temperature": 0.5, "top_k": 0},
    {"prompt": [7, 7, 7, 7], "max_new_tokens": 7, "seed": 4},
    {"prompt": [250, 1, 99], "max_new_tokens": 11, "seed": 5,
     "temperature": 0.8, "top_k": 20},
]


@pytest.fixture(scope="module")
def jax_model():
    return jgen.TinyLM(0)


@pytest.fixture(scope="module")
def serving(jax_model):
    """One port engine (the JAX TinyLM's weights) + registry + HTTP server
    shared by the module."""
    reg = ModelRegistry()
    eng = reg.load_generator(
        "gen-t", model=mxt.convert.tinylm_from_jax(jax_model, ctx=mxt.cpu()),
        **GEO)
    srv = ServingServer(reg, port=0).start()
    try:
        yield type("S", (), {"eng": eng, "reg": reg, "srv": srv,
                             "host": srv.host, "port": srv.port})
    finally:
        srv.stop()


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


# ----------------------------------------------------------- KV allocator
def test_blocks_for_and_allocator_are_the_references():
    for t, bs in ((1, 8), (8, 8), (9, 8), (0, 8), (33, 16)):
        assert kvcache.blocks_for(t, bs) == jkv.blocks_for(t, bs)
    for mod in (kvcache, jkv):
        a = mod.BlockAllocator(4)
        first = a.alloc(2)
        assert first == [0, 1] and a.used == 2 and a.free_count == 2
        second = a.alloc(2)
        assert second == [2, 3] and a.free_count == 0
        a.free(second)
        assert a.alloc(1) == [3]                  # LIFO reuse
        a.free(first)
        a.free([3])
        assert a.used == 0 and a.free_count == 4
        b = mod.BlockAllocator(3)
        b.alloc(2)
        with pytest.raises(mod.KVCacheOOM):
            b.alloc(2)
        assert b.free_count == 1                  # all or nothing
        with pytest.raises(ValueError):
            b.free([7])
    assert kvcache.pool_shape(6, 4, 2, 3, 5) == jkv.pool_shape(6, 4, 2, 3, 5)
    assert kvcache.pool_bytes(6, 4, 2, 3, 5) == jkv.pool_bytes(6, 4, 2, 3, 5)
    assert kvcache.make_pool(6, 4, 2, 3, 5).shape == (6, 4, 2, 2, 3, 5)
    with pytest.raises(ValueError, match="make_pool"):
        kvcache.write_seq(torch.zeros(6, 4, 2, 2, 3, 5), onp.arange(3),
                          onp.zeros((12, 2, 3, 5), "float32"),
                          onp.zeros((12, 2, 3, 5), "float32"), 4)


# ----------------------------------------------------- KV cache index ops
def _kv(rng, n, layers, heads, hd):
    return (rng.randn(n, layers, heads, hd).astype("float32"),
            rng.randn(n, layers, heads, hd).astype("float32"))


def test_write_append_gather_equal_the_references_bit_for_bit():
    """The same writes into a port pool and a JAX pool: the pools agree
    bit for bit (every byte outside the live positions still zero in
    both), and so do the gathers, out-of-range table entries included."""
    bs, layers, heads, hd, nb, mb = 4, 2, 2, 3, 6, 3
    rng = onp.random.RandomState(0)
    tp = kvcache.make_pool(nb, bs, layers, heads, hd)
    jp = jkv.make_pool(nb, bs, layers, heads, hd)
    # two sequences: lengths 7 (blocks 5, 2) and 3 (block 0); positions
    # past a length are padding, table entries nb are "nowhere"
    for blocks, length in (([5, 2, nb], 7), ([0, nb, nb], 3)):
        k, v = _kv(rng, mb * bs, layers, heads, hd)
        blocks = onp.array(blocks, onp.int32)
        kvcache.write_seq(tp, blocks, k, v, onp.int32(length))
        jp = jkv.write_seq(jp, blocks, k, v, onp.int32(length))
    assert tp.numpy().tobytes() == onp.asarray(jp).tobytes()
    tables = onp.array([[5, 2, nb], [0, nb, nb], [1, 3, 4]], onp.int32)
    lengths = onp.array([7, 3, 9], onp.int32)
    active = onp.array([True, True, False])
    for layer in range(layers):
        k = rng.randn(3, heads, hd).astype("float32")
        v = rng.randn(3, heads, hd).astype("float32")
        kvcache.append_token(tp, tables, lengths, layer, k, v,
                             active=active)
        jp = jkv.append_token(jp, tables, lengths, layer, k, v,
                              active=active)
    got, want = tp.numpy(), onp.asarray(jp)
    assert got.tobytes() == want.tobytes()
    live = onp.zeros(got.shape[:2], bool)
    live[5, :], live[2, :] = True, True          # seq 0: 8 positions
    live[0, :4] = True                           # seq 1: 4 positions
    assert not got[~live].any()                  # the rest untouched
    assert not got[1].any() and not got[3].any()  # the inactive row's
    for layer in range(layers):
        tk, tv = kvcache.gather_layer(tp, tables, layer)
        jk, jv = jkv.gather_layer(jp, tables, layer)
        assert tk.numpy().tobytes() == onp.asarray(jk).tobytes()
        assert tv.numpy().tobytes() == onp.asarray(jv).tobytes()


def test_paged_attention_matches_the_reference_and_dense():
    B, T, heads, hd = 3, 12, 2, 4
    rng = onp.random.RandomState(2)
    q = rng.randn(B, heads, hd).astype(onp.float32)
    keys = rng.randn(B, T, heads, hd).astype(onp.float32)
    values = rng.randn(B, T, heads, hd).astype(onp.float32)
    lengths = onp.array([4, 12, 1], onp.int32)
    got = kvcache.paged_attention(torch.as_tensor(q), torch.as_tensor(keys),
                                  torch.as_tensor(values),
                                  torch.as_tensor(lengths)).numpy()
    want = onp.asarray(jkv.paged_attention(q, keys, values, lengths))
    onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for b in range(B):
        for h in range(heads):
            att = keys[b, :lengths[b], h] @ q[b, h] / onp.sqrt(hd)
            w = onp.exp(att - att.max())
            w /= w.sum()
            onp.testing.assert_allclose(got[b, h],
                                        w @ values[b, :lengths[b], h],
                                        rtol=2e-5, atol=2e-6)


# ------------------------------------------------------------- the model
def test_tinylm_from_jax_and_its_prefill_equal_the_references(jax_model):
    import jax
    tm = mxt.convert.tinylm_from_jax(jax_model, ctx=mxt.cpu())
    assert tm.model_id() == jax_model.model_id()
    assert onp.array_equal(tm.emb.numpy(), onp.asarray(jax_model.emb))
    tokens = onp.zeros((2, 16), onp.int32)
    tokens[0, :3], tokens[1, :5] = [3, 5, 8], [9, 1, 200, 4, 4]
    lengths = onp.array([3, 5], onp.int32)
    zeros_i, zeros_f = onp.zeros(2, onp.int32), onp.zeros(2, onp.float32)
    k, v, first = tm.prefill(torch.as_tensor(tokens),
                             torch.as_tensor(lengths),
                             torch.as_tensor(zeros_i),
                             torch.as_tensor(zeros_f),
                             torch.as_tensor(zeros_i))
    jk, jv, jfirst = jax.vmap(jax_model.prefill_one)(
        tokens, lengths, zeros_i, zeros_f, zeros_i)
    onp.testing.assert_allclose(k.numpy(), onp.asarray(jk), rtol=1e-5,
                                atol=1e-6)
    onp.testing.assert_allclose(v.numpy(), onp.asarray(jv), rtol=1e-5,
                                atol=1e-6)
    assert first.tolist() == onp.asarray(jfirst).tolist()   # greedy


def test_greedy_tokens_equal_the_jax_engines(serving, jax_model):
    je = jgen.GenerativeEngine(name="gen-jax", model=jax_model, **GEO)
    try:
        for prompt in ([3, 5, 8], [200, 4], list(range(1, 14)), [42],
                       [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                        15]):
            want = je.generate_sequential(prompt, max_new_tokens=12)
            assert serving.eng.generate_sequential(
                prompt, max_new_tokens=12) == want, prompt
        # and through the continuous path of both engines
        reqs = [dict(prompt=[10 + i, 3 * i], max_new_tokens=6 + i)
                for i in range(4)]
        want = [s.tokens(timeout=120.0) for s in
                [je.submit(**r) for r in reqs]]
        got = [s.tokens(timeout=60.0) for s in
               [serving.eng.submit(**r) for r in reqs]]
        assert got == want
    finally:
        je.close()


def test_sampler_follows_the_top_k_softmax_and_ignores_the_batch():
    tm = gen.TinyLM(0, ctx=mxt.cpu())
    n = 6000
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -3.0]).repeat(n, 1)
    seeds = torch.arange(n, dtype=torch.int32)
    ngen = torch.full((n,), 3, dtype=torch.int32)
    temps = torch.full((n,), 0.8)
    for k in (0, 3):
        topks = torch.full((n,), k, dtype=torch.int32)
        draw = tm._sample(logits, seeds, ngen, temps, topks).numpy()
        p = torch.softmax(logits[0] / 0.8, -1).numpy()
        if k:
            p[k:] = 0
            p /= p.sum()
        freq = onp.bincount(draw, minlength=6) / n
        assert 0.5 * onp.abs(freq - p).sum() < 0.025, (k, freq, p)
        if k:
            assert not freq[k:].any()
        # row 17 alone draws what it drew among 6000
        alone = tm._sample(logits[17:18], seeds[17:18], ngen[17:18],
                           temps[17:18], topks[17:18])
        assert int(alone[0]) == int(draw[17])
    greedy = tm._sample(logits[:2], seeds[:2], ngen[:2],
                        torch.zeros(2), torch.zeros(2, dtype=torch.int32))
    assert greedy.tolist() == [0, 0]


# ---------------------------------------- continuous = sequential
def test_continuous_batching_equals_sequential_with_join_leave(serving):
    e = serving.eng
    refs = [e.generate_sequential(**r) for r in MIXED]
    streams = [e.submit(tenant="bitexact", **r) for r in MIXED]
    got = [s.tokens(timeout=60.0) for s in streams]
    for r, ref, g in zip(MIXED, refs, got):
        assert g == ref, r
    assert _wait(lambda: e._alloc.used == 0)


def test_submit_validation_errors(serving, monkeypatch):
    e = serving.eng
    for kw in ({"prompt": []}, {"prompt": [1] * (GEO["prefill_len"] + 1)},
               {"prompt": [999999]}, {"prompt": [1], "max_new_tokens": 0},
               {"prompt": [1], "max_new_tokens": GEO["max_tokens"] + 1},
               {"prompt": [1], "seed": "x"}):
        with pytest.raises(gen.BadGenRequest):
            e.submit(**kw)
    # MXTPU_GEN_SLO_INTER_TOKEN_MS: a per-tenant inter_token SLO fed one
    # outcome per token gap (the first token's delay is TTFT, not a gap),
    # as the JAX package's engine does
    from incubator_mxnet_tpu_torch.telemetry import slo
    monkeypatch.setenv("MXTPU_GEN_SLO_INTER_TOKEN_MS", "250")
    eng = gen.GenerativeEngine(name="gen-slo", ctx=mxt.cpu(), **GEO)
    try:
        toks, _reason = eng.submit([1, 2, 3], max_new_tokens=4,
                                   temperature=0.0,
                                   tenant="acme").tokens(timeout=60.0)
        objective = slo.REGISTRY.get("gen-slo/inter_token/acme")
        assert objective is not None and objective.kind == "inter_token"
        assert objective.describe()["model"] == "gen-slo"
        good, bad = objective._ledger.window_counts(
            objective.window_s, objective.clock())
        assert good + bad == len(toks) - 1, (good, bad, toks)
    finally:
        eng.close()
    assert slo.REGISTRY.get("gen-slo/inter_token/acme") is None


def test_decode_numeric_error_retires_row_and_frees_kv():
    e = gen.GenerativeEngine(name="gen-nan", seed=0, ctx=mxt.cpu(), **GEO)
    try:
        real = e._decode_fn

        def poisoned(pool=None):
            fn = real(pool)

            def wrapped(*a):
                (out,) = fn(*a)
                out = out.copy()
                out[1] = 0                  # row_finite False everywhere
                return [out]
            return wrapped

        e._decode_fn = poisoned
        used0 = e._alloc.used
        stream = e.submit([5, 6, 7], max_new_tokens=8, seed=3)
        toks, reason = stream.tokens(timeout=60.0)
        assert reason == "numeric_error" == stream.finish_reason
        assert len(toks) <= 1
        assert _wait(lambda: e._alloc.used == used0)
        retires = [ev for ev in flightrec.snapshot()
                   if ev["event"] == "gen_retire"
                   and ev.get("model") == "gen-nan"]
        assert retires and retires[-1]["reason"] == "numeric_error"
    finally:
        e.close()


def test_decode_steps_run_inside_the_launch_gate():
    """Every decode step is a unit of device work (``devstats.LAUNCH_GATE``):
    a profiler transition waits for the step in flight, so a profile
    capture cannot stop while the loop replays its graph."""
    from incubator_mxnet_tpu_torch.telemetry import devstats
    e = gen.GenerativeEngine(name="gen-gate", seed=0, ctx=mxt.cpu(), **GEO)
    try:
        real, depths = e._decode_fn, []

        def watched(pool=None):
            fn = real(pool)

            def wrapped(*a):
                depths.append(getattr(devstats.LAUNCH_GATE._local, "depth",
                                      0))
                return fn(*a)
            return wrapped

        e._decode_fn = watched
        toks, reason = e.submit([5, 6, 7], max_new_tokens=4,
                                seed=3).tokens(timeout=60.0)
        assert reason == "max_tokens" and len(toks) == 4
        assert depths and all(d > 0 for d in depths)
    finally:
        e.close()
    assert devstats.LAUNCH_GATE._inside == 0


# ------------------------------------------- captured programs (stand-in)
def test_warm_captures_every_program_and_decode_captures_nothing_after(
        cpu_graphs, serving):
    """Through the CPU stand-in: warm() builds the prefill, decode and
    join programs (plus the sequential path's decode and join), one
    capture each at max_batch rows, counted on the compile counter;
    traffic afterwards captures nothing and lands no gen:compile span,
    and its tokens equal the eager engine's."""
    kinds = ("eval", "serve", "decode")
    c0 = sum(tjit._COMPILES.value(kind=k) for k in kinds)
    e = gen.GenerativeEngine(name="gen-cap", model=serving.eng.model,
                             **GEO)
    try:
        c1 = sum(tjit._COMPILES.value(kind=k) for k in kinds)
        assert c1 - c0 == 5
        assert e._prefill.buckets == e.decode_buckets == [GEO["max_batch"]]
        assert all(p.captured is not None for p in e._programs.values())
        spans.reset()
        refs = [serving.eng.generate_sequential(**r) for r in MIXED]
        got = [s.tokens(timeout=60.0) for s in
               [e.submit(**r) for r in MIXED]]
        assert got == refs
        assert e.generate_sequential(**MIXED[0]) == refs[0]
        assert sum(tjit._COMPILES.value(kind=k) for k in kinds) == c1
        assert not [s for s in spans.snapshot()
                    if s["name"] in ("gen:compile", "eval:compile")]
        assert set(cpu_graphs.threads) == {threading.current_thread().name}
    finally:
        e.close()
    assert not any(k in e._keys for k in tjit.aot.CACHE.keys())


# --------------------------------------------------------- HTTP streaming
def _gen_http(host, port, body, headers=None, read_tokens=None,
              timeout=60.0):
    """One POST /generate -> (status, headers, [parsed lines]); with
    ``read_tokens`` it hangs up after that many lines."""
    c = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        c.request("POST", "/generate", json.dumps(body).encode("utf-8"),
                  {"Content-Type": "application/json", **(headers or {})})
        r = c.getresponse()
        hdrs = dict(r.getheaders())
        if r.status != 200:
            return r.status, hdrs, [json.loads(r.read().decode("utf-8"))]
        lines, buf = [], b""
        while True:
            ch = r.read(1)
            if not ch:
                break
            buf += ch
            if ch == b"\n":
                lines.append(json.loads(buf.decode("utf-8")))
                buf = b""
                if read_tokens is not None and len(lines) >= read_tokens:
                    c.sock.close()
                    return r.status, hdrs, lines
                if lines[-1].get("done"):
                    break
        return r.status, hdrs, lines
    finally:
        c.close()


def test_http_streaming_8_clients_one_disconnects(serving):
    e = serving.eng
    reqs = [{"model": "gen-t", "prompt": [10 + i, 20 + i],
             "max_new_tokens": 10 + (i % 4), "seed": 100 + i,
             "temperature": 0.6 if i % 2 else 0.0, "top_k": 25}
            for i in range(8)]
    refs = [e.generate_sequential(
        r["prompt"], r["max_new_tokens"], temperature=r["temperature"],
        top_k=r["top_k"], seed=r["seed"]) for r in reqs]
    results = [None] * 8

    def client(i):
        results[i] = _gen_http(
            serving.host, serving.port, reqs[i],
            headers={"X-Request-Id": "e2e-%d" % i,
                     "X-MXTPU-Tenant": "t-e2e"},
            read_tokens=2 if i == 3 else None)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not any(t.is_alive() for t in threads)
    for i, (status, hdrs, lines) in enumerate(results):
        assert status == 200, (i, results[i])
        assert hdrs.get("X-Request-Id") == "e2e-%d" % i
        if i == 3:
            continue
        toks = [ln["token"] for ln in lines if "token" in ln]
        done = [ln for ln in lines if ln.get("done")]
        assert toks == refs[i][0], i
        assert done and done[0]["reason"] == refs[i][1]
    assert _wait(lambda: e._alloc.used == 0)
    recs = [json.loads(ln) for ln in
            accesslog.export_jsonl(500).splitlines() if ln]
    assert any(r["model"] == "gen-t" and r["tenant"] == "t-e2e"
               and r["code"] == 200 for r in recs)
    assert any(r["model"] == "gen-t" and r["code"] == 499 for r in recs)


def test_http_error_contract_and_listing(serving):
    st, _h, body = _gen_http(serving.host, serving.port,
                             {"model": "gen-t", "prompt": []})
    assert st == 400 and "error" in body[0]
    st, _h, body = _gen_http(serving.host, serving.port,
                             {"model": "nope", "prompt": [1]})
    assert st == 404
    st, _h, lines = _gen_http(serving.host, serving.port,
                              {"prompt": [7], "max_new_tokens": 2})
    assert st == 200 and lines[-1].get("done")
    c = http.client.HTTPConnection(serving.host, serving.port, timeout=30)
    try:
        c.request("GET", "/v1/models")
        payload = json.loads(c.getresponse().read().decode("utf-8"))
    finally:
        c.close()
    d = {g["name"]: g for g in payload["generators"]}["gen-t"]
    assert d["kind"] == "generator"
    assert d["kv_blocks_total"] == GEO["num_blocks"]
    assert d["decode_buckets"][-1] == GEO["max_batch"]
    text = telemetry.export_text()
    assert 'mxtpu_gen_tokens_total{model="gen-t"' in text
    assert 'mxtpu_gen_kv_blocks_total{model="gen-t"}' in text
    assert "mxtpu_gen_inter_token_ms_bucket" in text
