"""telemetry.slo on the CPU, against the JAX package's
(incubator_mxnet_tpu/telemetry/slo.py; its tests/test_slo.py): the same
outcomes on the same injected clock through both packages' SLO objects
give the same burn rates, budgets and alert states (the same float
arithmetic: exact), and the server feeds each terminal outcome into the
model's ledger (404 probes never mint an SLO).
"""
import json

import numpy as onp
import pytest

from incubator_mxnet_tpu.telemetry import slo as jslo

from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.telemetry import slo


class Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _pair():
    clocks = (Clock(100.0), Clock(100.0))
    objs = [pkg.SLO("s", "m", target=0.9, window_s=60.0,
                    windows=[(5.0, 20.0)], fast_burn=2.0, slow_burn=1.0,
                    clock=c)
            for pkg, c in zip((slo, jslo), clocks)]
    return clocks, objs


def _plain(transitions):
    """Alert transitions without the package's AlertPair objects."""
    return [(p.name, state, a, b) for p, state, a, b in transitions]


def test_burn_budget_and_alerts_equal_the_references_on_a_fake_clock():
    """A scripted burst of errors, then recovery, at 0.5 s steps: every
    read (burn rates, budget, alert-pair states and transitions, the
    describe dict) is the reference's."""
    clocks, (port, ref) = _pair()
    rng = onp.random.RandomState(3)
    for step in range(120):
        t = 100.0 + 0.5 * step
        for c in clocks:
            c.t = t
        bad_rate = 0.6 if 20 <= step < 50 else 0.02
        codes = [500 if rng.rand() < bad_rate else 200 for _ in range(4)]
        for code in codes:
            assert _plain(port.observe(code, now=t)) == \
                _plain(ref.observe(code, now=t))
        assert _plain(port.evaluate(t)) == _plain(ref.evaluate(t))
        for w in (5.0, 20.0, 60.0):
            assert port.burn_rate(w, t) == ref.burn_rate(w, t)
        assert port.budget_remaining(t) == ref.budget_remaining(t)
        assert port.describe(t) == ref.describe(t)
    assert [p.state for p in port.pairs] == [p.state for p in ref.pairs]


def test_registry_observe_describe_and_detach_as_the_reference():
    regs = [pkg.SLORegistry(publish=False, clock=Clock(10.0))
            for pkg in (slo, jslo)]
    for reg in regs:
        reg.observe("m", 200, latency_ms=5.0)
        reg.observe("m", 503, latency_ms=5.0)
        reg.observe("ghost", 404)            # not eligible: no SLO minted
    got, want = (r.describe() for r in regs)
    assert got == want
    assert regs[0].names_for_model("ghost") == []
    for reg in regs:
        reg.detach_model("m")
    assert regs[0].describe() == regs[1].describe() == {"slos": []}


def test_the_server_feeds_the_ledger_and_serves_debug_slo():
    """Each terminal predict outcome lands in the model's SLOs; GET
    /debug/slo describes them; a probe of an unknown model never seeds
    one."""
    import http.client

    class Echo:
        def predict_batch(self, x):
            return (x,)
    srv = serving.serve({"slo-echo": Echo()}, port=0, max_batch_size=2,
                        batch_timeout_ms=1)
    try:
        def post(name):
            c = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
            c.request("POST", "/v1/models/%s:predict" % name,
                      json.dumps({"inputs": [[1.0, 2.0]]}),
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            r.read()
            c.close()
            return r.status
        assert [post("slo-echo") for _ in range(3)] == [200] * 3
        assert post("no-such-model") == 404
        c = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        c.request("GET", "/debug/slo")
        body = json.loads(c.getresponse().read())
        c.close()
        mine = [s for s in body["slos"] if s["model"] == "slo-echo"]
        assert mine and all(s["budget_remaining"] == 1.0 for s in mine)
        assert not [s for s in body["slos"] if s["model"] == "no-such-model"]
        objective = slo.REGISTRY.for_model("slo-echo")[0]
        good, bad = objective._ledger.window_counts(objective.window_s,
                                                    objective.clock())
        assert (good, bad) == (3, 0)
    finally:
        srv.stop()
    assert slo.REGISTRY.for_model("slo-echo") == []     # detached


@pytest.mark.parametrize("spec", ["300:3600,3600:21600", "1:2,3:4,5:6"])
def test_window_specs_parse_as_the_reference(spec):
    assert slo._parse_windows(spec) == jslo._parse_windows(spec)
