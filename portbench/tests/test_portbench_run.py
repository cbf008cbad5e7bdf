"""A whole run of each cell at a tiny size on the CPU (the harness's look
for a card skipped): the last line's shape for ``--trace 0`` and
``--trace 1``, each reference against the port, and the exits the contract
asks for."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import run
from portbench.core import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2 ** 31 + 977


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_last_line_shape(tiny, name, trace):
    cell = tiny(name)
    line, detail = run.run_cell(name, SEED, 0.5, trace, "cpu", cell=cell)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    json.dumps(line)
    assert line["correct"] is True, (line["checks"], detail)
    assert line["attempted"] > 0 and line["failed"] == 0
    wanted = cell.per_layer if trace else cell.end_to_end
    got = line["metrics"]
    assert set(got) <= {m["name"] for m in wanted}
    for m in wanted:
        if m["name"] in got:
            assert got[m["name"]]["unit"] == m["unit"]
            assert got[m["name"]]["value"] >= 0
    if not trace:
        assert set(got) == {m["name"] for m in wanted}
        assert got["setup_s"]["value"] > 0
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    for name_, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_forbidden_modules_compare_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "incubator_mxnet_tpu_torch_x",
                        sys.modules["json"])
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys.modules["json"])
    monkeypatch.setitem(sys.modules, "incubator_mxnet_tpu.ops",
                        sys.modules["json"])
    assert run.forbidden_modules() == ["incubator_mxnet_tpu", "jaxlib"]


def test_the_port_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import portbench.run as r; "
            "r.import_port(%r); import portbench.core.train, "
            "portbench.core.serve; print(r.forbidden_modules())"
            % (spec.ROOT, spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Where torch sees no card the run exits 2 and prints nothing on
    standard output."""
    code = ("import sys, torch; sys.argv[1:] = ['--workload', "
            "'bert_large.squad_s384', '--seed', '5', '--seconds', '1']; "
            "torch.cuda.is_available = lambda: False; "
            "sys.path.insert(0, %r); import portbench.run as r; "
            "sys.exit(r.main())" % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "is_available" in out.stderr


def test_reference_matches_the_port_forward(tiny):
    """The SQuAD reference and the served block's forward on the same
    weights, on the CPU in fp32."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.torch import to_torch
    from portbench.core import weights
    cell = tiny("bert_large.squad_s384")
    cfg, m = cell.config, cell.model
    net = m.build(mxt, cfg, "span_qa", mxt.cpu())
    specs = m.param_specs(cfg, "span_qa")
    w = weights.make(specs, 3, torch.device("cpu"), torch.float32)
    weights.load_into(net, w)
    ids, types = m.make_requests(cfg, cell.traffic,
                                 weights.generator(3, "cpu", 1), "cpu")
    got = to_torch(net(ids[:4], types[:4]))
    want = cell.reference.span_qa(cfg, "fp32")(w, ids[:4], types[:4])
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
