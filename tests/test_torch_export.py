"""Programs on disk, on the CPU: K1 as the ``mxtpu::flash_fwd`` operator,
``jit.export_forward``, ``contrib.serving`` (``export_model``, ``load``,
``ServedModel``), ``HybridBlock.export`` -> ``SymbolBlock.imports``,
``serve`` of a ``.mxtpu`` path and the ``aot`` artifact layer
(``MXTPU_AOT_CACHE_DIR``), against the JAX package's.

A small BERT (2 layers, 64 wide, one head of 64, so K1 takes its
attention) gets the same weights in both packages
(``mxt.from_jax_params``). The port's loaded program equals the port's
eager forward bit for bit (it runs the same ATen ops, and K1's plain
version on the CPU); against the JAX package's loaded program the
tolerance is the float32 one of tests/test_torch_serving_http.py
(2e-5 relative to the largest logit). The artifact layer is held to the
JAX package's tests/test_aot.py: a fresh process loads instead of running
the net's Python forward, and a corrupt, truncated or old-version file
rebuilds. One test starts a subprocess.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu.contrib import serving as jcs

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import aot, jit as tjit, models as tmodels
from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.contrib import serving as tcs
from incubator_mxnet_tpu_torch.ops import _kernels, attention

V, S, B = 50, 16, 4
KW = dict(vocab_size=V, units=64, hidden_size=128, num_layers=2,
          num_heads=1, max_length=S, dropout=0.0, attention="flash")
TOL = 2e-5


@pytest.fixture(scope="module")
def berts():
    jnet = jmodels.BERTModel(**KW)
    jnet.initialize(mx.init.Xavier())
    tnet = tmodels.BERTModel(**KW)
    tnet.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                               jnet._collect_params_with_prefix().items()})
    return jnet, tnet


def _tokens(n=B, seed=0):
    return onp.random.RandomState(seed).randint(0, V, (n, S)).astype("int32")


def _eager(tnet, rows):
    with torch.no_grad():
        return tnet(mxt.nd.array(rows, ctx=mxt.cpu(),
                                 dtype="int32")).asnumpy()


def _close(got, ref, what):
    scale = float(onp.abs(ref).max())
    err = float(onp.abs(onp.asarray(got) - ref).max()) / scale
    assert err <= TOL, "%s: %.3g of the largest logit" % (what, err)


# ------------------------------------------------------------- K1's operator
def test_k1_fake_kernel_shapes_and_flop_formula():
    """The fake kernel gives ``out`` like q and ``lse`` (B*H, 1, S) fp32,
    launching nothing; ``FlopCounterMode`` counts 4·B·H·pairs·D (pairs
    S² or S(S+1)/2 causal, PERF.md §6's count)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    before = dict(_kernels.LAUNCHES)
    with FakeTensorMode():
        q = torch.empty(2, 3, 64, 128, dtype=torch.bfloat16)
        out, lse = torch.ops.mxtpu.flash_fwd(q, q, q, True, 0.1)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert lse.shape == (6, 1, 64) and lse.dtype == torch.float32
    assert dict(_kernels.LAUNCHES) == before
    q = torch.randn(2, 3, 64, 64)
    for causal, pairs in ((False, 64 * 64), (True, 64 * 65 // 2)):
        with FlopCounterMode(display=False) as fc:
            attention.flash_attention(q, q, q, causal=causal)
        assert fc.get_total_flops() == 4 * 2 * 3 * pairs * 64
        assert attention.fwd_flops(q.shape, causal) == 4 * 2 * 3 * pairs * 64


@pytest.mark.parametrize("lse", [False, True])
def test_k2_k3_fake_kernel_shapes_and_flop_formula(lse):
    """K2 and K3 are one operator, ``mxtpu::flash_bwd``: its fake kernel
    gives dq, dk, dv like q, k, v, launching nothing, and
    ``FlopCounterMode`` counts one attention forward + backward (with the
    LSE output's cotangent too) as K1's 4· plus K2's 8· and K3's 6·
    B·H·pairs·D exactly (PERF.md §6's counts); the gradients are the
    plain backward's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    before = dict(_kernels.LAUNCHES)
    with FakeTensorMode():
        q = torch.empty(2, 3, 64, 128, dtype=torch.bfloat16)
        lse_rows = torch.empty(6, 1, 64)
        got = torch.ops.mxtpu.flash_bwd(q, q, q, q, lse_rows, q, True, 0.1,
                                        None)
    assert [g.shape for g in got] == [q.shape] * 3
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert dict(_kernels.LAUNCHES) == before
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 64, 64, generator=gen).requires_grad_()
               for _ in range(3))
    for causal, pairs in ((False, 64 * 64), (True, 64 * 65 // 2)):
        with FlopCounterMode(display=False) as fc:
            if lse:
                out, rows = attention.flash_attention_lse(q, k, v, causal)
                loss = out.sum() + rows.sum()
            else:
                loss = attention.flash_attention(q, k, v, causal).sum()
            grads = torch.autograd.grad(loss, (q, k, v))
        assert fc.get_total_flops() == (4 + 8 + 6) * 2 * 3 * pairs * 64
        assert attention.bwd_flops(q.shape, causal) == \
            (8 + 6) * 2 * 3 * pairs * 64
        out, lse_rows = attention._fa_reference(q.detach(), k.detach(),
                                                v.detach(), causal, 0.125)
        g_lse = torch.ones(2, 3, 64) if lse else None
        want = attention._fa_bwd_reference(
            q.detach(), k.detach(), v.detach(), out, lse_rows,
            torch.ones_like(out), causal, 0.125, g_lse)
        for g, w in zip(grads, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_export_holds_k1_as_one_node_per_layer(berts):
    _, tnet = berts
    program = tjit.export_forward(tnet, [torch.tensor(_tokens())])
    nodes = [n for n in program.graph.nodes
             if "mxtpu.flash_fwd" in str(n.target)]
    assert len(nodes) == KW["num_layers"]
    # the parameters are the program's first inputs, not its state
    assert not program.state_dict
    assert len(program.graph_signature.user_inputs) == \
        len(list(tnet.collect_params().values())) + 1


# ---------------------------------------------------------- contrib.serving
def test_exported_bert_equals_eager_and_the_jax_packages(berts, tmp_path):
    jnet, tnet = berts
    rows = _tokens()
    ref = _eager(tnet, rows)
    tpath, jpath = str(tmp_path / "t.mxtpu"), str(tmp_path / "j.mxtpu")
    tcs.export_model(tnet, [torch.tensor(rows)], tpath)
    jcs.export_model(jnet, [mx.nd.array(rows, dtype="int32")], jpath)
    tm, jm = tcs.load(tpath), jcs.load(jpath)
    assert tm.input_shapes == jm.input_shapes == [(B, S)]
    assert tm.output_shapes == jm.output_shapes == [(B, S, V)]
    assert tm.batch_size == jm.batch_size == B
    got = tm.predict(rows).asnumpy()
    assert onp.array_equal(got, ref)
    assert onp.array_equal(tm.predict(rows).asnumpy(), ref)   # cached
    _close(got, jm.predict(mx.nd.array(rows, dtype="int32")).asnumpy(),
           "loaded port vs loaded JAX program")
    with pytest.raises(ValueError, match="not an mxtpu serving artifact"):
        tcs.load(jpath)


def test_predict_batch_chunks_and_pads_as_the_reference(berts, tmp_path):
    """n items through the fixed exported batch B: ceil(n/B) chunks, the
    last padded with its final row, the padding dropped (the reference's
    contrib/serving.py:240-275)."""
    jnet, tnet = berts
    path = str(tmp_path / "t.mxtpu")
    tm = tcs.export_model(tnet, [torch.tensor(_tokens())], path)
    jpath = str(tmp_path / "j.mxtpu")
    jm = jcs.export_model(jnet, [mx.nd.array(_tokens(), dtype="int32")],
                          jpath)
    for n in (3, 4, 6, 9):
        rows = _tokens(n, seed=n)
        (got,) = tm.predict_batch(rows)
        assert got.shape == (n, S, V)
        assert onp.array_equal(got, _eager(tnet, rows))
        (ref,) = jm.predict_batch(rows)
        _close(got, ref, "predict_batch n=%d" % n)


def test_departures_export_mlir_and_pjrt_bundle(berts, tmp_path):
    """export_mlir returns the exported program's text, not StableHLO;
    export_pjrt_bundle returns an AOTInductor package and its manifest,
    not StableHLO and compile options (ROADMAP §3, departures; the
    runner's tests are tests/test_torch_aoti.py)."""
    _, tnet = berts
    path = str(tmp_path / "t.mxtpu")
    tcs.export_model(tnet, [torch.tensor(_tokens())], path)
    text = tcs.export_mlir(path)
    assert "ExportedProgram" in text and "mxtpu.flash_fwd" in text
    assert "stablehlo" not in text
    out = str(tmp_path / "bundle")
    package, manifest = tcs.export_pjrt_bundle(path, out)
    assert package == os.path.join(out, "model.pt2")
    assert manifest == os.path.join(out, "manifest.json")
    with open(manifest) as f:
        m = json.load(f)
    assert m["package"] == "model.pt2" and m["device"] == "cpu"
    assert m["inputs"] == [dict(shape=[B, S], dtype="int32")]
    assert m["outputs"] == [dict(shape=[B, S, V], dtype="float32")]
    assert os.path.exists(m["op_library"])


def test_hybrid_export_and_symbolblock_imports_as_the_reference(berts,
                                                                tmp_path):
    jnet, tnet = berts
    rows = _tokens()
    tnet.export(str(tmp_path / "t"), example_inputs=[torch.tensor(rows)])
    jnet.export(str(tmp_path / "j"),
                example_inputs=[mx.nd.array(rows, dtype="int32")])
    for name in ("t", "j"):
        for suffix in ("-0000.params", "-symbol.json", ".mxtpu"):
            assert (tmp_path / (name + suffix)).exists(), name + suffix
    tman = json.loads((tmp_path / "t-symbol.json").read_text())
    jman = json.loads((tmp_path / "j-symbol.json").read_text())
    assert tman == {"format": "incubator_mxnet_tpu.hybrid",
                    "class": "BERTModel", "artifact": "t.mxtpu"}
    assert set(jman) == set(tman) and jman["class"] == tman["class"]
    tblock = mxt.gluon.SymbolBlock.imports(str(tmp_path / "t-symbol.json"),
                                           ["data"])
    jblock = mx.gluon.SymbolBlock.imports(str(tmp_path / "j-symbol.json"),
                                          ["data"])
    got = tblock(mxt.nd.array(rows, ctx=mxt.cpu(), dtype="int32")).asnumpy()
    assert onp.array_equal(got, _eager(tnet, rows))
    _close(got, jblock(mx.nd.array(rows, dtype="int32")).asnumpy(),
           "imports")
    loaded = mxt.nd.load(str(tmp_path / "t-0000.params"))
    assert sorted(loaded) == sorted(mx.nd.load(str(tmp_path /
                                                   "j-0000.params")))


def test_serve_an_artifact_path_through_the_registry_and_http(berts,
                                                              tmp_path):
    """``serve({"bert": path})`` loads the artifact; the registry serves the
    ServedModel (a prewarm over its buckets first) and its replies equal
    the eager forward."""
    import http.client
    _, tnet = berts
    path = str(tmp_path / "t.mxtpu")
    tcs.export_model(tnet, [torch.tensor(_tokens())], path)
    rows = _tokens(3, seed=7)
    ref = _eager(tnet, rows)
    reg = serving.ModelRegistry()
    try:
        reg.load("warm", tcs.load(path), max_batch_size=2,
                 batch_timeout_ms=5, warm_spec=[((S,), "int32")])
        got = [reg.predict("warm", r, timeout=60.0)[0] for r in rows]
        assert onp.array_equal(onp.stack(got), ref)
    finally:
        reg.close()
    srv = serving.serve({"bert": path}, port=0, max_batch_size=2,
                        batch_timeout_ms=5)
    try:
        c = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        c.request("POST", "/v1/models/bert:predict",
                  json.dumps({"inputs": [rows[0].tolist()],
                              "dtype": "int32"}),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        body = json.loads(r.read().decode())
        c.close()
        assert r.status == 200, body
        assert onp.array_equal(onp.asarray(body["outputs"][0], "float32"),
                               ref[0])
    finally:
        srv.stop()


# ------------------------------------------------------ the artifact layer
def _files(cache_dir):
    return [os.path.join(dp, f) for dp, _dn, fs in os.walk(cache_dir)
            for f in fs if f.endswith(".mxtpu-aot")]


def _fresh_keys(shape):
    for k in list(aot.CACHE.keys()):
        if k.input_sig and k.input_sig[0][0] == shape:
            aot.CACHE.discard(k)


def _dense(seed=0):
    net = mxt.gluon.nn.Dense(3, in_units=4)
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    return net


def _compiles():
    return tjit._COMPILES.value(kind="eval")


def test_model_id_leaves_out_hooks_and_module_bookkeeping():
    """An artifact is found by a key whose model id must be the same in
    every process: a registered hook (MXNet's or torch.nn.Module's tables)
    does not change it; a different width does."""
    nets = [_dense(seed) for seed in (0, 1)]
    nets[1].register_forward_pre_hook(lambda *a: None)
    nets[1].register_forward_hook(lambda *a: None)
    torch.nn.Module.register_forward_pre_hook(nets[1], lambda *a: None)
    ids = {aot.model_id_for(n, extra=("eval",)) for n in nets}
    assert len(ids) == 1
    wider = mxt.gluon.nn.Dense(4, in_units=4)
    wider.initialize(ctx=mxt.cpu())
    assert aot.model_id_for(wider, extra=("eval",)) not in ids


@pytest.mark.parametrize("damage", ["corrupt", "truncated", "old_version"])
def test_damaged_artifacts_rebuild(tmp_path, monkeypatch, damage):
    """The reference's test_aot.py:266-345: a file that is garbage, whose
    v2 header overruns it, or that carries the v1 magic is never
    misparsed: no artifact hit, one fresh build (the export)."""
    monkeypatch.setenv("MXTPU_AOT_CACHE_DIR", str(tmp_path))
    shape = {"corrupt": (7, 4), "truncated": (13, 4),
             "old_version": (6, 4)}[damage]
    x = torch.ones(shape)
    ref = tjit.EvalStep(_dense())(x).asnumpy()
    files = _files(str(tmp_path))
    assert files
    for path in files:
        buf = open(path, "rb").read()
        assert buf.startswith(aot.ARTIFACT_MAGIC)
        with open(path, "wb") as f:
            f.write({"corrupt": b"garbage",
                     "truncated": aot.ARTIFACT_MAGIC + b"\xff\xff\xff\xff{}",
                     "old_version": b"MXTPUAOT\x001"
                     + buf[len(aot.ARTIFACT_MAGIC):]}[damage])
    _fresh_keys(shape)
    hits0, c0 = aot._ARTIFACT_HITS.value(kind="eval"), _compiles()
    step = tjit.EvalStep(_dense())
    assert onp.array_equal(step(x).asnumpy(), ref)
    assert aot._ARTIFACT_HITS.value(kind="eval") == hits0
    assert _compiles() == c0 + 1
    assert step._last_stats and step._last_stats["flops"] > 0


def test_facts_for_key_reads_the_header_and_memos(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_AOT_CACHE_DIR", str(tmp_path))
    step = tjit.EvalStep(_dense())
    x = torch.ones((5, 4))
    step(x)
    (key,) = [k for k in step._keys]
    ref = aot.facts_for_key(key)
    buf = open(ref.path, "rb").read()
    assert ref.digest == aot.program_digest(buf)
    assert ref.stats["flops"] == 2 * 5 * 4 * 3   # the matmul, 2·M·N·K
    assert ref.stats["bytes_accessed"] is None
    assert aot.facts_for_key(key) is ref                 # memoized
    os.utime(ref.path, ns=(0, 12345))
    again = aot.facts_for_key(key)
    assert again is not ref and again == ref
    assert aot.facts_for_key(key._replace(kind="train")) is None


_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as onp, torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import aot, jit, models, telemetry
    from incubator_mxnet_tpu_torch.telemetry import spans
    kw, buckets = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    net = models.BERTModel(**kw)
    net.initialize(ctx=mxt.cpu())
    net.load_parameters(sys.argv[3], ctx=mxt.cpu())
    forwards = [0]
    forward = models.BERTModel.forward

    def counted(self, *a, **k):   # on the class: the instance is untouched
        forwards[0] += 1
        return forward(self, *a, **k)
    models.BERTModel.forward = counted
    step = jit.EvalStep(net)
    rows = onp.random.RandomState(0).randint(0, kw["vocab_size"],
                                             (max(buckets), kw["max_length"]))
    outs = [step(torch.tensor(rows[:b], dtype=torch.int32)).asnumpy()
            .tolist() for b in buckets]
    print(json.dumps({
        "hits": aot._ARTIFACT_HITS.value(kind="eval"),
        "compiles": jit._COMPILES.value(kind="eval"),
        "forwards": forwards[0],
        "sources": [e["source"] for e in aot.CACHE.snapshot()],
        "flops": [e["stats"]["flops"] for e in aot.CACHE.snapshot()],
        "compile_spans": [s["name"] for s in spans.snapshot()
                          if s["name"] == "eval:compile"],
        "outs": outs}))
""")


def test_artifacts_load_in_a_fresh_process_without_a_python_forward(
        berts, tmp_path):
    """Buckets 1, 2, 4 of the BERT built here (export + write); a fresh
    process loads one artifact per bucket (hits = buckets), runs the net's
    Python forward 0 times (counted on the class), builds nothing,
    keeps the header's FLOPs, and answers bit for bit as this process."""
    _, tnet = berts
    cache_dir = str(tmp_path / "aotcache")
    buckets = [1, 2, 4]
    rows = onp.random.RandomState(0).randint(0, V, (4, S))
    env = dict(os.environ, MXTPU_AOT_CACHE_DIR=cache_dir,
               JAX_PLATFORMS="cpu")
    old = os.environ.get("MXTPU_AOT_CACHE_DIR")
    os.environ["MXTPU_AOT_CACHE_DIR"] = cache_dir
    try:
        step = tjit.EvalStep(tnet)
        here = [step(torch.tensor(rows[:b], dtype=torch.int32)).asnumpy()
                for b in buckets]
        step.release()
    finally:
        if old is None:
            os.environ.pop("MXTPU_AOT_CACHE_DIR")
        else:
            os.environ["MXTPU_AOT_CACHE_DIR"] = old
    assert len(_files(cache_dir)) == len(buckets)
    params = str(tmp_path / "bert.params")
    tnet.save_parameters(params)
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(KW), json.dumps(buckets),
         params], capture_output=True, text=True, env=env, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["hits"] == len(buckets), rec
    assert rec["forwards"] == 0 and rec["compiles"] == 0, rec
    assert rec["compile_spans"] == [], rec
    assert rec["sources"] == ["artifact"] * len(buckets)
    assert all(f > 0 for f in rec["flops"])
    for got, want in zip(rec["outs"], here):
        assert onp.array_equal(onp.asarray(got, "float32"), want)


def test_generation_programs_persist_and_load(cpu_graphs, tmp_path,
                                              monkeypatch):
    """The engine's prefill and decode programs through the layer (the
    CPU stand-in for the graphs): exported with the weights and the KV
    pool as inputs, written once, and loaded by a second engine, whose
    greedy tokens and pool equal an engine that traced its model."""
    from incubator_mxnet_tpu_torch.serving import generate as gen
    geo = dict(block_size=8, num_blocks=48, max_batch=4, prefill_len=16,
               max_tokens=24)
    prompts = [[1, 2, 3], [5, 9, 2, 7, 1]]

    def run(name):
        eng = gen.GenerativeEngine(name=name, ctx=mxt.cpu(), **geo)
        try:
            eng.warm()
            toks = [eng.submit(p, max_new_tokens=8, temperature=0.0)
                    .tokens(timeout=60.0)[0] for p in prompts]
            return toks, eng._pool.clone()
        finally:
            eng.close()
    traced, pool = run("gen-traced")
    monkeypatch.setenv("MXTPU_AOT_CACHE_DIR", str(tmp_path))
    w0 = {k: aot._ARTIFACT_WRITES.value(kind=k) for k in ("serve", "decode")}
    h0 = {k: aot._ARTIFACT_HITS.value(kind=k) for k in ("serve", "decode")}
    aot.CACHE.clear()
    run("gen-export")
    assert {k: aot._ARTIFACT_WRITES.value(kind=k) - w0[k]
            for k in w0} == {"serve": 1, "decode": 1}
    aot.CACHE.clear()
    loaded, lpool = run("gen-load")
    assert aot._ARTIFACT_HITS.value(kind="serve") - h0["serve"] >= 1
    assert aot._ARTIFACT_HITS.value(kind="decode") - h0["decode"] >= 1
    assert loaded == traced
    assert torch.equal(lpool, pool)


from test_torch_aot import cpu_graphs  # noqa: E402,F401 — a fixture
