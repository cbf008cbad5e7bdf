"""``mx.npx`` of the port against the JAX package's, on the CPU, and the
reference's own tests of ``mx.np``/``mx.npx``.

Every ``npx`` and ``npx.image`` case of ``tests/np_cases.py`` (each name
of ``test_np_parity.py``'s ``NPX_OPS`` and ``NPX_IMAGE`` lists) runs the
same seeded inputs through both namespaces: float32 within 1e-5 + 1e-6
relative, ints and bools exact, shapes equal. The reference's tests of
its namespace (``tests/test_np.py``, ``tests/test_np_parity.py``) run
against the port as they stand, with the package's name swapped.
"""
import pathlib

import numpy as onp
import pytest

import incubator_mxnet_tpu as mx
import incubator_mxnet_tpu_torch as mxt

import np_cases as C

_TESTS = pathlib.Path(__file__).parent


@pytest.fixture(scope="module")
def both():
    with mxt.cpu():
        return C.inputs(mx.np), C.inputs(mxt.np)


_CASES = C.NPX_CASES + C.NPX_IMAGE_CASES


@pytest.mark.parametrize("label,fn", _CASES, ids=[c[0] for c in _CASES])
def test_npx_name_against_the_reference(both, label, fn):
    xj, xt = both
    want = C.host(fn(mx.np, mx.npx, xj))
    with mxt.cpu():
        got = C.host(fn(mxt.np, mxt.npx, xt))
    C.compare(got, want, label)


def _reference_tests(name):
    """The reference's test module ``name`` with the JAX package's name
    replaced by the port's, run inside ``cpu()``."""
    src = (_TESTS / name).read_text().replace("incubator_mxnet_tpu",
                                              "incubator_mxnet_tpu_torch")
    ns = {"__name__": "port_" + name[:-3]}
    exec(compile(src, "port/" + name, "exec"), ns)
    return ns


_REF_NP = [n for n in _reference_tests("test_np.py") if n.startswith("test_")]
_REF_PARITY = [n for n in _reference_tests("test_np_parity.py")
               if n.startswith("test_")]


@pytest.mark.parametrize("name", _REF_NP)
def test_reference_np_tests_hold(name):
    ns = _reference_tests("test_np.py")
    mxt.random.seed(0)
    with mxt.cpu():
        ns[name]()


@pytest.mark.parametrize("name", _REF_PARITY)
def test_reference_surface_tests_hold(name):
    ns = _reference_tests("test_np_parity.py")
    mxt.random.seed(0)
    with mxt.cpu():
        ns[name]()


def test_npx_keeps_outputs_on_the_tape_and_inputs_intact():
    with mxt.cpu():
        x = mxt.np.array([[-1.0, 2.0, 0.5]])
        x.attach_grad()
        with mxt.autograd.record():
            y = mxt.npx.relu(x)
            z = mxt.np.sum(y * y)
        z.backward()
        assert isinstance(y, mxt.np.ndarray)
        onp.testing.assert_allclose(x.grad.asnumpy(), [[0.0, 4.0, 1.0]])
        d = mxt.nd.array([1.0, 2.0], ctx=mxt.cpu())
        out = mxt.npx.dropout(d, p=0.5)       # eval mode: the identity
        assert out is not d and type(d) is mxt.nd.NDArray


def test_npx_save_load_round_trip(tmp_path):
    with mxt.cpu():
        a = mxt.np.array([[1.0, 2.0]])
        f = str(tmp_path / "a.params")
        mxt.npx.save(f, {"a": a})
        back = mxt.npx.load(f)
        assert isinstance(back["a"], mxt.np.ndarray)
        assert back["a"].tolist() == [[1.0, 2.0]]
    # the JAX package reads the file the port wrote
    jback = mx.npx.load(f)
    onp.testing.assert_array_equal(jback["a"].asnumpy(), [[1.0, 2.0]])
