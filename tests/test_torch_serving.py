"""The port's serving path — ModelRegistry → DynamicBatcher → BlockServable →
EvalStep → model — on the CPU, against the single-row forward and the JAX
package's registry.

Tolerance: 1e-5 absolute and relative between a served row and the port's
single-row forward (the same float32 arithmetic at another batch size),
1e-4 against the JAX registry (another framework's float32 sums).
"""
import threading

import numpy as onp
import pytest

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu import serving as jserving

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import models as tmodels
from incubator_mxnet_tpu_torch import serving

V, S = 97, 32
KW = dict(vocab_size=V, units=128, hidden_size=128, num_layers=1,
          num_heads=2, max_length=S, dropout=0.0, attention="flash")


@pytest.fixture(scope="module")
def nets():
    jnet = jmodels.BERTModel(**KW)
    jnet.initialize(mx.init.Xavier())
    tnet = tmodels.BERTModel(**KW)
    tnet.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                               jnet._collect_params_with_prefix().items()})
    return jnet, tnet


def _rows(n, seed=0):
    return onp.random.RandomState(seed).randint(0, V, (n, S)).astype("int32")


def _client_threads(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)


def test_concurrent_requests_match_single_row_and_jax_registry(nets):
    jnet, tnet = nets
    rows = _rows(12)
    reg = serving.ModelRegistry()
    reg.load("bert", tnet, max_batch_size=4, batch_timeout_ms=50)
    replies = {}

    def client(c):
        for i in range(c, len(rows), 4):
            replies[i] = reg.predict("bert", rows[i])

    try:
        _client_threads(client, 4)
        snap = reg.metrics("bert").snapshot()
    finally:
        reg.close()
    assert snap["ok_count"] == len(rows) and snap["error_count"] == 0
    assert snap["batch_count"] < len(rows)      # requests were coalesced
    step = mxt.jit.EvalStep(tnet)
    jreg = jserving.ModelRegistry()
    jreg.load("bert", jnet, max_batch_size=4)
    try:
        for i, row in enumerate(rows):
            (served,) = replies[i]
            assert served.shape == (S, V) and served.dtype == onp.float32
            single = step(row[None])[0].asnumpy()
            onp.testing.assert_allclose(served, single, atol=1e-5, rtol=1e-5)
            (jax_reply,) = jreg.predict("bert", row)
            onp.testing.assert_allclose(served, onp.asarray(jax_reply),
                                        atol=1e-4, rtol=1e-4)
    finally:
        jreg.close()


def test_bucket_padding_leaves_real_rows_unchanged(nets):
    _, tnet = nets
    rows = _rows(3, seed=1)
    seen = []

    class Recording(serving.BlockServable):
        def predict_batch(self, *stacked, replica=0):
            seen.append(stacked[0].shape[0])
            return super().predict_batch(*stacked, replica=replica)

    batcher = serving.DynamicBatcher(Recording(tnet), max_batch_size=4,
                                     batch_timeout_ms=500)
    try:
        reqs = [batcher.submit(r) for r in rows]
        outs = [r.result(60)[0] for r in reqs]
    finally:
        batcher.close()
    assert seen == [4]                          # 3 real rows, padded to 4
    assert batcher.metrics.padded_items == 1
    ref = mxt.jit.EvalStep(tnet)(rows).asnumpy()
    for out, r in zip(outs, ref):
        onp.testing.assert_allclose(out, r, atol=1e-5, rtol=1e-5)


def test_queue_full_error_at_capacity():
    release = threading.Event()

    class Blocking:
        def predict_batch(self, x):
            release.wait(30)
            return (x,)

    reg = serving.ModelRegistry()
    reg.load("slow", Blocking(), max_batch_size=1, batch_timeout_ms=0,
             queue_size=2)
    try:
        first = reg.submit("slow", onp.zeros(2, "float32"))
        # wait until the worker holds the first request, then fill the queue
        for _ in range(2000):
            if reg.models()[0]["queue_depth"] == 0:
                break
            threading.Event().wait(0.005)
        queued = [reg.submit("slow", onp.full(2, i, "float32"))
                  for i in (1, 2)]
        with pytest.raises(serving.QueueFullError):
            reg.submit("slow", onp.zeros(2, "float32"))
        assert reg.metrics("slow").rejected_count == 1
    finally:
        release.set()
    for i, req in enumerate([first] + queued):
        onp.testing.assert_array_equal(req.result(30)[0], onp.full(2, i))
    reg.close()


def test_deadline_expires_queued_requests_and_unload_drains():
    release = threading.Event()

    class Blocking:
        def predict_batch(self, x):
            release.wait(30)
            return (x * 2,)

    reg = serving.ModelRegistry()
    reg.load("m", Blocking(), max_batch_size=1, batch_timeout_ms=0)
    held = reg.submit("m", onp.ones(1, "float32"))
    late = reg.submit("m", onp.ones(1, "float32"), deadline_ms=0)
    release.set()
    onp.testing.assert_array_equal(held.result(30)[0], [2.0])
    with pytest.raises(serving.DeadlineExceededError):
        late.result(30)
    reg.unload("m")
    assert reg.models() == []
    with pytest.raises(serving.ModelNotFoundError):
        reg.predict("m", onp.ones(1, "float32"))


def test_bf16_outputs_come_back_as_float32(nets):
    _, tnet = nets
    net = tmodels.BERTModel(**KW)
    net.initialize(ctx=mxt.cpu())
    net.load_state_dict(tnet.state_dict())
    net.cast("bfloat16")
    (out,) = serving.BlockServable(net).predict_batch(_rows(2))
    assert out.dtype == onp.float32 and out.shape == (2, S, V)
    ref = mxt.jit.EvalStep(net)(_rows(2))
    assert ref.dtype == "bfloat16"
    onp.testing.assert_array_equal(out, ref.asnumpy())


def test_replicas_share_the_load_and_each_gets_its_index():
    seen = set()
    lock = threading.Lock()
    release = threading.Event()

    def servable(x, replica=0):
        with lock:
            seen.add(replica)
        release.wait(10)
        return (x + replica,)

    batcher = serving.DynamicBatcher(servable, max_batch_size=1,
                                     batch_timeout_ms=0, replicas=2)
    try:
        reqs = [batcher.submit(onp.zeros(1, "float32")) for _ in range(4)]
        release.set()
        outs = sorted(float(r.result(30)[0][0]) for r in reqs)
    finally:
        batcher.close()
    assert seen == {0, 1}
    assert outs[0] == 0.0 and outs[-1] == 1.0


def _old_to_host(t):
    """BlockServable's conversion before the pinned copy: widen on the
    device, then a pageable copy."""
    import torch
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _outputs(device):
    import torch
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 33, 257, generator=g) * 1e3
    x[0, 0, :3] = torch.tensor([float("inf"), float("-inf"), float("nan")])
    return [x.to(torch.bfloat16).to(device), x.to(device),
            torch.arange(12, dtype=torch.int32).to(device)]


def test_host_copy_is_the_old_conversion_bit_for_bit():
    from incubator_mxnet_tpu_torch.serving.registry import _to_host
    for t in _outputs("cpu"):
        got, want = _to_host(t), _old_to_host(t)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.cuda
def test_host_copy_from_the_card_is_the_old_conversion_bit_for_bit():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from incubator_mxnet_tpu_torch.serving.registry import _to_host
    for t in _outputs("cuda"):
        got, want = _to_host(t), _old_to_host(t)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
