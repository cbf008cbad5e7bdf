"""telemetry.numwatch on the CPU, against the JAX package's
(incubator_mxnet_tpu/telemetry/numwatch.py; its tests/test_numwatch.py).

The reducer's bundle [finite fraction, abs-max, rms] equals the
reference's on the same arrays (float32 tolerance 1e-6 relative: two
summation orders); the stride clock, the nan_storm hysteresis, the
shadow comparison and ``describe`` are the reference's. The port's
serving tap reduces a BlockServable's outputs on their device before the
host copy (``tapping`` + ``device_tap``); a servable returning host
arrays is reduced on the host. ``ModelRegistry.register_shadow`` flips a
model degraded on a breach, as the reference's.
"""
import time

import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu.telemetry import numwatch as jnum

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.telemetry import faultlab, flightrec, numwatch


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("MXTPU_NUMWATCH_SAMPLE", "1")
    for pkg in (numwatch, jnum):
        pkg.reset()
    flightrec.reset()
    yield
    faultlab.disarm()
    for pkg in (numwatch, jnum):
        pkg.reset()


def _arrays():
    rng = onp.random.RandomState(0)
    a = rng.randn(3, 5).astype("float32") * 4
    b = rng.randn(7).astype("float32")
    b[2], b[5] = onp.nan, -onp.inf
    return a, b


def test_reducer_bundle_equals_the_references():
    a, b = _arrays()
    got = numwatch.reduce_stats([torch.tensor(a), torch.tensor(b)]).numpy()
    want = onp.asarray(jnum._reducer_entry(
        ((a.shape, "float32"), (b.shape, "float32"))).fn(a, b))
    assert onp.allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == pytest.approx(20 / 22)


def test_tap_stride_and_storm_hysteresis_equal_the_references(monkeypatch):
    """Every other dispatch taps at rate 0.5; a non-finite tap opens one
    episode (one nan_storm event), more keep it open, a finite one
    closes it: the same describe() in both packages."""
    monkeypatch.setenv("MXTPU_NUMWATCH_SAMPLE", "0.5")
    a, b = _arrays()
    for arrays in ([a], [b], [b], [b], [a], [a], [b], [b]):
        numwatch.tap("m", "serve:outputs", [torch.tensor(x) for x in arrays])
        jnum.tap("m", "serve:outputs", arrays)
    got, want = numwatch.describe(), jnum.describe()
    g, w = got["taps"]["m/serve:outputs"], want["taps"]["m/serve:outputs"]
    assert {k: g[k] for k in ("sampled", "nonfinite", "storms", "in_storm")} \
        == {k: w[k] for k in ("sampled", "nonfinite", "storms", "in_storm")}
    assert onp.allclose(g["last"], w["last"], rtol=1e-6)
    assert got["sample_stride"] == want["sample_stride"] == 2
    storms = [e for e in flightrec.snapshot() if e["event"] == "nan_storm"]
    assert len(storms) == g["storms"] == 2


class _Logits:
    """A servable of fixed logits (host arrays), optionally offset."""

    def __init__(self, offset=0.0):
        self.offset = offset

    def predict_batch(self, x):
        base = onp.tile(onp.arange(4, dtype="float32"), (x.shape[0], 1))
        return (base * x[:, :1] + self.offset,)


def test_serving_tap_shadow_breach_and_nan_poison():
    """The batcher taps ``serve:outputs`` (finite fraction 1.0), a shadow
    whose logits are offset past the threshold breaches once and flips
    the model degraded, and faultlab's nan_poison at batcher.dispatch puts
    a NaN into a batch: one storm episode."""
    reg = serving.ModelRegistry()
    try:
        reg.load("m", _Logits(), max_batch_size=2, batch_timeout_ms=1)
        reg.register_shadow("m", _Logits(offset=0.5), stride=1,
                            threshold=0.25)
        x = onp.ones(3, "float32")
        for _ in range(3):
            reg.predict("m", x, timeout=30.0)
        assert numwatch.shadow_drain(30.0)
        d = numwatch.describe()
        assert d["taps"]["m/serve:outputs"]["last"][0] == 1.0
        sh = d["shadows"]["m"]
        assert sh["samples"] == 3 and sh["breached"]
        assert sh["last"]["max_abs_diff"] == pytest.approx(0.5)
        assert sh["last"]["top1_agreement"] == 1.0
        assert reg.health()["status"] == "degraded"
        assert "shadow divergence breach" in reg.models()[0]["degraded"]
        assert reg.unregister_shadow("m") is True
        faultlab.arm("batcher.dispatch:nan_poison:stride=1:budget=1")
        (out,) = reg.predict("m", x, timeout=30.0)
        assert onp.isnan(out).any()
        tap = numwatch.describe()["taps"]["m/serve:outputs"]
        assert tap["storms"] == 1 and tap["in_storm"]
        reg.predict("m", x, timeout=30.0)
        assert not numwatch.describe()["taps"]["m/serve:outputs"]["in_storm"]
    finally:
        reg.close()
    # the batcher's close detaches the model's series
    assert "m/serve:outputs" not in numwatch.describe()["taps"]


def test_device_tap_reduces_block_outputs_before_the_host_copy():
    """A BlockServable hands its outputs to ``device_tap`` inside the
    batcher's ``tapping`` scope: the bundle is made from the tensors, and
    outside a sampled scope nothing runs."""
    net = mxt.gluon.nn.Dense(4, in_units=3)
    net.initialize(ctx=mxt.cpu())
    x = onp.ones((2, 3), "float32")
    tap = numwatch.tapping("blk", "serve:outputs")
    with tap:
        outs = serving.BlockServable(net).predict_batch(x)
    assert tap.bundle is not None
    tap.finish(outs)
    assert numwatch.describe()["taps"]["blk/serve:outputs"]["last"][0] == 1.0
    numwatch.device_tap([torch.ones(2)])        # no scope: a no-op
    off = numwatch.tapping("blk", "serve:outputs")
    off.sampled = False
    with off:
        numwatch.device_tap([torch.ones(2)])
    assert off.bundle is None and off.finish([onp.ones(2)]) is None


def test_decode_loop_notes_the_logits_finiteness():
    """The decode loop notes ``gen:logits`` each step over its live rows,
    as the reference's generate.py:848."""
    from incubator_mxnet_tpu_torch.serving import generate as gen
    eng = gen.GenerativeEngine(name="gen-nw", ctx=mxt.cpu(), block_size=8,
                               num_blocks=48, max_batch=4, prefill_len=16,
                               max_tokens=24)
    try:
        eng.submit([1, 2, 3], max_new_tokens=4,
                   temperature=0.0).tokens(timeout=60.0)
        deadline = time.monotonic() + 10
        while "gen-nw/gen:logits" not in numwatch.describe()["taps"] and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        tap = numwatch.describe()["taps"]["gen-nw/gen:logits"]
        assert tap["sampled"] >= 3 and tap["last"][0] == 1.0
    finally:
        eng.close()
