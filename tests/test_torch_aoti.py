"""The Python-free serving bundle on the CPU: ``contrib.serving.
export_pjrt_bundle`` (an AOTInductor package of a ``.mxtpu`` artifact's
program and its manifest), K1 as the C++ operator ``mxtpu::flash_fwd``
(``ops/csrc/flash_fwd_op.cpp``, its plain version on CPU tensors) and the
runner ``native/src/aoti_serve.cc``, the counterpart of
``tools/pjrt_serve.c``.

One bundle is built for the module: a small BERT (2 layers, 64 wide, one
head of 64, so attention is K1's operator) with the JAX package's weights
(``mxt.from_jax_params``), exported at B 4 x S 16. The runner runs in a
fresh process that maps no libpython. Its output is bit for bit that of
``torch._inductor.aoti_load_package`` of the same package in this process
(the same compiled code, and the C++ plain version makes the Python one's
ATen calls in the same order); against the JAX package's served model on
the same weights it holds the float32 tolerance of tests/test_torch_
export.py (2e-5 of the largest logit: Inductor fuses and sums in another
order than XLA).
"""
import json
import os
import subprocess

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu.contrib import serving as jcs

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import models as tmodels
from incubator_mxnet_tpu_torch.contrib import serving as tcs
from incubator_mxnet_tpu_torch.native import lib

V, S, B = 50, 16, 4
KW = dict(vocab_size=V, units=64, hidden_size=128, num_layers=2,
          num_heads=1, max_length=S, dropout=0.0, attention="flash")
TOL = 2e-5
FORWARDS = 2          # the runner's two forwards


def _tokens(seed=0):
    return onp.random.RandomState(seed).randint(0, V, (B, S)).astype("int32")


def _run(argv, hold=False):
    """The runner; with ``hold``, its /proc/<pid>/maps read while it waits
    after "done". Returns (key/value lines, maps, exit code, stderr)."""
    if not hold:
        r = subprocess.run(argv, capture_output=True, text=True, timeout=120)
        return {}, "", r.returncode, r.stderr + r.stdout
    proc = subprocess.Popen([argv[0], "--hold", *argv[1:]],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines, maps = {}, ""
    try:
        for line in proc.stdout:
            if line.strip() == "done":
                with open("/proc/%d/maps" % proc.pid) as f:
                    maps = f.read()
                break
            key, _, val = line.strip().partition(" ")
            lines[key] = val
        proc.stdin.close()
        err = proc.stderr.read()
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return lines, maps, proc.returncode, err


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("aoti")
    jnet = jmodels.BERTModel(**KW)
    jnet.initialize(mx.init.Xavier())
    tnet = tmodels.BERTModel(**KW)
    tnet.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tnet, jnet)
    rows = _tokens()
    artifact = str(tmp / "bert.mxtpu")
    tcs.export_model(tnet, [torch.from_numpy(rows)], artifact)
    package, manifest = tcs.export_pjrt_bundle(artifact, str(tmp / "bundle"))
    with open(manifest) as f:
        manifest = json.load(f)
    inp, out = str(tmp / "in.bin"), str(tmp / "out.bin")
    rows.tofile(inp)
    runner = lib.build_aoti_serve()
    lines, maps, rc, err = _run([runner, manifest["op_library"], package,
                                 inp, out, "%d,%d" % (B, S)], hold=True)
    assert rc == 0, err
    got = onp.fromfile(out, dtype=onp.float32).reshape(B, S, V)
    jm = jcs.export_model(jnet, [mx.nd.array(rows, dtype="int32")],
                          str(tmp / "j.mxtpu"))
    return dict(package=package, manifest=manifest, runner=runner,
                rows=rows, lines=lines, maps=maps, got=got, tmp=tmp,
                jax=onp.asarray(jm.predict_batch(rows)[0]))


def test_bundle_is_a_package_and_a_manifest(bundle):
    m = bundle["manifest"]
    assert os.path.basename(bundle["package"]) == m["package"] == \
        "model.pt2"
    assert m["device"] == "cpu" and m["format"] == "mxtpu-aoti-1"
    assert m["inputs"] == [dict(shape=[B, S], dtype="int32")]
    assert m["outputs"] == [dict(shape=[B, S, V], dtype="float32")]
    assert os.path.exists(m["op_library"])


def test_runner_is_bit_for_bit_aoti_load_package(bundle):
    import torch._inductor
    model = torch._inductor.aoti_load_package(bundle["package"])
    want = model(torch.from_numpy(bundle["rows"])).numpy()
    assert want.dtype == onp.float32 and want.shape == (B, S, V)
    assert onp.array_equal(bundle["got"], want)
    lines = bundle["lines"]
    assert lines["device"] == "cpu" and lines["repeat_equal"] == "true"
    # K1's plain version a layer a forward; no kernel launches on the CPU
    assert int(lines["k1_plain_calls"]) == KW["num_layers"] * FORWARDS
    assert int(lines["k1_launches"]) == 0
    assert float(lines["load_s"]) >= 0 and \
        float(lines["forward2_ms"]) > 0


def test_runner_is_within_tolerance_of_the_jax_served_model(bundle):
    got, ref = bundle["got"], bundle["jax"]
    assert onp.isfinite(got).all()
    err = float(onp.abs(got - ref).max()) / float(onp.abs(ref).max())
    assert err <= TOL, "%.3g of the largest logit" % err


def test_runner_process_holds_no_python(bundle):
    """The runner's mapped files, read while it runs: libtorch and the
    operator library, no libpython, nothing of JAX or the JAX package."""
    mapped = {line.split()[-1] for line in bundle["maps"].splitlines()
              if len(line.split()) > 5}
    assert any("libtorch_cpu" in m for m in mapped)
    assert bundle["manifest"]["op_library"] in mapped
    bad = [m for m in mapped if "libpython" in m or "jax" in m
           or "incubator_mxnet_tpu/" in m]
    assert not bad, bad


def test_cpp_schema_is_the_python_registration(bundle):
    r = subprocess.run([bundle["runner"], "--schema",
                        bundle["manifest"]["op_library"]],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "schema %s" % (
        torch.ops.mxtpu.flash_fwd.default._schema,)


def test_runner_fails_loudly(bundle):
    """A missing package, a wrong shape and a bad usage exit non-zero with
    the error; nothing is written."""
    tmp, m = bundle["tmp"], bundle["manifest"]
    inp = str(tmp / "in.bin")
    for package, shape in ((str(tmp / "none.pt2"), "%d,%d" % (B, S)),
                           (bundle["package"], "%d,%d" % (B, S + 1))):
        out = str(tmp / "never.bin")
        _, _, rc, err = _run([bundle["runner"], m["op_library"], package,
                              inp, out, shape])
        assert rc != 0 and "aoti_serve: FAIL" in err, err
        assert not os.path.exists(out)
    _, _, rc, err = _run([bundle["runner"], m["op_library"]])
    assert rc == 2 and "usage" in err


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    broken = tmp_path / "flash_fwd_op.cpp"
    broken.write_text("this is not C++;\n")
    monkeypatch.setattr(lib, "FLASH_OP_SOURCE", str(broken))
    monkeypatch.setattr(lib, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as caught:
        lib.build_flash_op()
    assert "error" in str(caught.value)
