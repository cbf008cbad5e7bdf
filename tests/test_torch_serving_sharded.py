"""The port's MeshServable against the JAX package's, on the CPU.

The JAX package's own batcher test of this servable is a known red
(``tests/test_serving_sharded.py::test_tp2_mesh_servable_bit_for_bit_
through_batcher``), so it is not the oracle here: the port's
``MeshServable`` is held against the JAX ``MeshServable.predict_batch``
called directly (within 1e-6: XLA's and torch's matmuls sum in another
order), bit for bit against the same per-shard products gathered (a
gather is exact), and within one fp32 rounding against the port's
``BlockServable`` of the same net (a CPU BLAS does not promise the same
bits across output widths). A BERT with
``tp_axis`` (row-parallel layers change the order of the sums) is held
within 1e-4. The port's groups are carved from ``devices=[cpu] * 8``.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu import serving as jserving

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import aot
from incubator_mxnet_tpu_torch import models as tmodels
from incubator_mxnet_tpu_torch import parallel as tpar
from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.ops import attention as tattn

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _reset_meshes(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_INTERPRET", "1")
    yield
    tpar.set_current_mesh(None)
    jpar.set_current_mesh(None)


def _col_parallel_pair(seed=3):
    mx.random.seed(seed)
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(jpar.ColParallelDense(12, in_units=8))
    jnet.initialize(mx.init.Xavier())
    tnet = mxt.gluon.nn.HybridSequential()
    tnet.add(tpar.ColParallelDense(12, in_units=8))
    tnet.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tnet, jnet)
    return jnet, tnet


def test_tp2_mesh_servable_bit_for_bit_against_jax_and_block_servable():
    jnet, tnet = _col_parallel_pair()
    x = onp.random.RandomState(0).randn(6, 8).astype("float32")
    want = onp.asarray(jserving.MeshServable(jnet, tp=2).predict_batch(x)[0])
    sv = serving.MeshServable(tnet, tp=2, devices=CPU8)
    assert sv.replicas == 1 and dict(sv.mesh.shape) == {"tp": 2}
    got = sv.predict_batch(x)[0]
    onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the same per-shard products, gathered: exact; the unsplit product
    # (BlockServable): within one fp32 rounding, as a CPU BLAS does not
    # promise the same bits across output widths
    dense = tnet[0]
    w, b = dense.weight.data()._data, dense.bias.data()._data
    with torch.no_grad():
        shards = torch.cat([torch.nn.functional.linear(
            torch.from_numpy(x), ws, bs) for ws, bs in
            zip(w.chunk(2, dim=0), b.chunk(2))], dim=-1).numpy()
    assert onp.array_equal(got, shards)
    want = serving.BlockServable(tnet).predict_batch(x)[0]
    onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    reg = serving.ModelRegistry()
    reg.load("tp2", sv, max_batch_size=4, batch_timeout_ms=2.0,
             warm_spec=[((8,), "float32")])
    try:
        for i in range(6):
            # the batcher pads to its buckets: the CPU's matmul rounds by
            # the batch's shape, so replies hold within one rounding
            out = reg.predict("tp2", x[i])
            onp.testing.assert_allclose(onp.asarray(out[0]), want[i],
                                        rtol=1e-6, atol=1e-6)
    finally:
        reg.close()


def test_tp2_replica_groups_compose_through_the_batcher():
    """tp = 2 x replicas = 4 over eight positions: every request answered
    (within one rounding: the buckets' shapes), the dispatch counts sum to the requests, and each group
    holds its own copy of the weights."""
    jnet, tnet = _col_parallel_pair()
    x = onp.random.RandomState(1).randn(8, 8).astype("float32")
    jwant = onp.asarray(jserving.MeshServable(jnet, tp=2).predict_batch(x)[0])
    want = serving.BlockServable(tnet).predict_batch(x)[0]
    onp.testing.assert_allclose(want, jwant, rtol=1e-6, atol=1e-6)
    sv = serving.MeshServable(tnet, tp=2, replicas=4, devices=CPU8)
    assert sv.replicas == 4
    w = tnet[0].weight._tensor()
    copies = [g[id(tnet[0].weight)] for g in sv._group_params]
    assert all(c.data_ptr() != w.data_ptr() for c in copies)
    assert len({c.data_ptr() for c in copies}) == 4
    reg = serving.ModelRegistry()
    reg.load("dptp", sv, max_batch_size=2, batch_timeout_ms=1.0,
             replicas=4, prewarm=False)
    try:
        reqs = [reg.submit("dptp", x[i]) for i in range(8)]
        for i, r in enumerate(reqs):
            onp.testing.assert_allclose(onp.asarray(r.result(60.0)[0]),
                                        want[i], rtol=1e-6, atol=1e-6)
        counts = reg._entry("dptp").batcher.replica_dispatch_counts()
        assert sum(counts) == 8
    finally:
        reg.close()


def test_prewarm_builds_every_bucket_replica_pair_once():
    _, tnet = _col_parallel_pair(seed=4)
    sv = serving.MeshServable(tnet, tp=2, replicas=2, devices=CPU8[:4],
                              model_id="prewarm-pairs")
    reg = serving.ModelRegistry()
    reg.load("pairs", sv, max_batch_size=4, batch_timeout_ms=1.0,
             replicas=2, warm_spec=[((8,), "float32")])
    try:
        keys = [k for k in aot.CACHE.keys() if k.model_id == "prewarm-pairs"]
        assert sorted((k.input_sig[0][0][0], k.extra[1]) for k in keys) == \
            sorted((b, r) for b in (1, 2, 4) for r in (0, 1))
        assert all(k.mesh == ((("tp", 2),), 2) for k in keys)
        assert reg.metrics("pairs").prewarm_count == 6
    finally:
        reg.close()
        sv.release()


def test_mesh_servable_validates_device_budget():
    _, tnet = _col_parallel_pair()
    with pytest.raises(ValueError, match="needs 10 devices"):
        serving.MeshServable(tnet, tp=2, replicas=5, devices=CPU8)
    with pytest.raises(ValueError, match="tp=99"):
        serving.MeshServable(tnet, tp=99, devices=CPU8)
    with pytest.raises(ValueError, match="replicas must be"):
        serving.MeshServable(tnet, tp=2, replicas=0, devices=CPU8)
    mesh = serving.serving_mesh(2, devices=CPU8)
    with pytest.raises(ValueError, match="not both"):
        serving.MeshServable(tnet, mesh=mesh, replicas=2)
    assert serving.MeshServable(tnet, mesh=mesh).mesh is mesh


def test_mesh_servable_artifact_layer_keeps_mesh_programs_in_memory(
        tmp_path, monkeypatch):
    """The counterpart of the JAX package's sharded artifact round trip
    holds the port's departure: with MXTPU_AOT_CACHE_DIR set a mesh program
    (a forward whose positions run in threads, which torch.export does not
    trace) is built and answered in memory, and no file is written; a
    second servable of the same net answers the same."""
    monkeypatch.setenv("MXTPU_AOT_CACHE_DIR", str(tmp_path))
    _, tnet = _col_parallel_pair()
    x = onp.random.RandomState(2).randn(4, 8).astype("float32")
    for key in [k for k in aot.CACHE.keys() if k.mesh is not None]:
        aot.CACHE.discard(key)
    ref = serving.MeshServable(tnet, tp=2, devices=CPU8).predict_batch(x)[0]
    assert not list(tmp_path.rglob("*.mxtpu-aot"))
    sv2 = serving.MeshServable(tnet, tp=2, devices=CPU8)
    assert onp.array_equal(sv2.predict_batch(x)[0], ref)
    entry = next(aot.CACHE.peek(k) for k in aot.CACHE.keys()
                 if k.mesh is not None)
    assert entry.source == "build"


def test_bert_tp_axis_mesh_servable_matches_jax_and_counts_k1(monkeypatch):
    """A two-layer BERT with ``tp_axis="tp"`` (row-parallel proj and ffn2)
    served tp = 2: within 1e-4 of the JAX MeshServable and of the port's
    BlockServable; one flash forward per layer per batch."""
    kw = dict(vocab_size=97, units=128, hidden_size=256, num_layers=2,
              num_heads=2, max_length=64, dropout=0.0, attention="flash",
              tp_axis="tp")
    mx.random.seed(0)
    jnet = jmodels.BERTModel(**kw)
    jnet.initialize(mx.init.Xavier())
    tnet = tmodels.BERTModel(**kw)
    tnet.initialize(mxt.init.Zero(), ctx=mxt.cpu())
    mxt.from_jax_params(tnet, jnet)
    tok = onp.random.RandomState(3).randint(0, 97, (4, 64)).astype("int32")
    want = onp.asarray(jserving.MeshServable(jnet, tp=2).predict_batch(tok)[0])
    calls = []
    fa = tattn._fa_call
    monkeypatch.setattr(tattn, "_fa_call",
                        lambda *a, **k: calls.append(1) or fa(*a, **k))
    sv = serving.MeshServable(tnet, tp=2, replicas=2, devices=CPU8[:4])
    for replica in (0, 1):
        del calls[:]
        got = sv.predict_batch(tok, replica=replica)[0]
        assert len(calls) == 2
        onp.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    plain = serving.BlockServable(tnet).predict_batch(tok)[0]
    onp.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-4)
