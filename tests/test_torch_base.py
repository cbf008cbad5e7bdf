"""The port's small modules against the JAX package's, on the CPU:
``base``/``error`` (the error classes and their registry), ``name``
(``NameManager``, ``Prefix``), ``attribute`` (``AttrScope``), ``registry``
(register/alias/create), ``context`` (``cpu_pinned``, ``num_tpus``),
``test_utils`` (comparisons, finite differences, ``random_seed``),
``convert`` (NDArray values) and ``nd.maximum_scalar``. Each test runs
the same calls through both packages and compares the results exactly.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import attribute as jattr
from incubator_mxnet_tpu import error as jerror
from incubator_mxnet_tpu import name as jname
from incubator_mxnet_tpu import registry as jregistry

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import attribute as tattr
from incubator_mxnet_tpu_torch import error as terror
from incubator_mxnet_tpu_torch import name as tname
from incubator_mxnet_tpu_torch import registry as tregistry
from incubator_mxnet_tpu_torch import test_utils as ttu


@pytest.mark.parametrize("pkg", [(jerror, mx), (terror, mxt)],
                         ids=["jax", "port"])
def test_error_classes_and_their_registry(pkg):
    error, top = pkg
    assert error.MXNetError is top.MXNetError
    assert issubclass(error.ValueError, (top.MXNetError, ValueError))
    assert issubclass(error.IndexError, IndexError)
    assert set(error._ERROR_REGISTRY) == {"InternalError", "ValueError",
                                          "TypeError", "IndexError"}

    @error.register("MyError")
    class MyError(error.MXNetError):
        pass
    assert error._ERROR_REGISTRY.pop("MyError") is MyError
    assert str(error.NotImplementedForSymbol(len)) == \
        "Function len is not implemented for Symbol."
    assert top.base.string_types == (str,)
    assert isinstance(onp.float32(1), top.base.numeric_types)


def _names(name):
    out = []
    with name.NameManager():
        out += [name.current().get(None, "fc"), name.current().get(None, "fc"),
                name.current().get("given", "fc")]
        with name.Prefix("net_"):
            out += [name.current().get(None, "conv")]
        out += [name.current().get(None, "conv")]
    return out


def test_name_manager_and_prefix_match_the_reference():
    assert _names(tname) == _names(jname) == \
        ["fc0", "fc1", "given", "net_conv0", "conv0"]


def _attrs(attribute):
    with attribute.AttrScope(group="a", lr="1"):
        with attribute.AttrScope(lr="2"):
            inner = attribute.current().get({"x": "y"})
        outer = attribute.current().get()
    return inner, outer, attribute.current().get()


def test_attr_scope_matches_the_reference():
    assert _attrs(tattr) == _attrs(jattr) == (
        {"group": "a", "lr": "2", "x": "y"}, {"group": "a", "lr": "1"}, {})


def _registry_run(registry):
    class Base:
        def __init__(self, v=0):
            self.v = v

    register = registry.get_register_func(Base, "thing")
    alias = registry.get_alias_func(Base, "thing")
    create = registry.get_create_func(Base, "thing")

    @alias("other")
    class One(Base):
        pass
    register(One)
    made = [create("one", 3).v, create("OTHER").v,
            create('{"name": "one", "v": 5}').v]
    inst = One(7)
    assert create(inst) is inst
    with pytest.raises(ValueError):
        create("missing")
    return made


def test_registry_functions_match_the_reference():
    assert _registry_run(tregistry) == _registry_run(jregistry) == [3, 0, 5]


def test_cpu_pinned_and_num_tpus():
    a = mxt.nd.array([1.0, 2.0], ctx=mxt.cpu_pinned())
    assert a.context == mxt.cpu() and a.asnumpy().tolist() == [1.0, 2.0]
    assert a._data.is_pinned() == torch.cuda.is_available()
    assert mxt.cpu_pinned(1).device_type == "cpu_pinned"
    assert mxt.num_tpus() == mxt.num_gpus()


def test_test_utils_checks_on_the_cpu():
    ttu.set_default_context(mxt.cpu())
    try:
        assert ttu.default_context() == mxt.cpu()
        ttu.check_numeric_gradient(lambda x, y: x * mxt.nd.exp(y),
                                   [onp.array([0.5, -1.0]),
                                    onp.array([0.2, 0.3])])
        a = ttu.rand_ndarray((3, 4))
        assert a.shape == (3, 4) and a.context == mxt.cpu()
        assert ttu.same(a, a.asnumpy()) and ttu.almost_equal(a, a + 1e-7)
        with pytest.raises(AssertionError, match="exceeds tolerance"):
            ttu.assert_almost_equal(a, a + 1)
    finally:
        ttu.set_default_context(None)
    with ttu.random_seed(3) as s:
        first = (onp.random.rand(), mxt.nd.random.uniform(
            shape=(2,), ctx=mxt.cpu()).asnumpy())
    with ttu.random_seed(3):
        again = (onp.random.rand(), mxt.nd.random.uniform(
            shape=(2,), ctx=mxt.cpu()).asnumpy())
    assert s == 3 and first[0] == again[0]
    onp.testing.assert_array_equal(first[1], again[1])
    assert len(ttu.rand_shape_nd(3)) == 3 and len(ttu.rand_shape_2d()) == 2


def test_from_jax_params_takes_ndarrays_of_either_package():
    net = mxt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mxt.cpu())
    w = onp.arange(6, dtype="float32").reshape(2, 3)
    mxt.from_jax_params(net, {"weight": mx.nd.array(w),
                              "bias": mxt.nd.array([1.0, 2.0],
                                                   ctx=mxt.cpu())})
    onp.testing.assert_array_equal(net.weight.data().asnumpy(), w)
    onp.testing.assert_array_equal(mxt.to_numpy_params(net)["bias"],
                                   [1.0, 2.0])


def test_maximum_scalar_and_waitall_match_the_reference():
    x = onp.array([-1.0, 0.5, 3.0], "float32")
    from incubator_mxnet_tpu.ndarray import ndarray as jndarray
    ref = jndarray.maximum_scalar(mx.nd.array(x), 0.75).asnumpy()
    got = mxt.nd.maximum_scalar(mxt.nd.array(x, ctx=mxt.cpu()), 0.75)
    onp.testing.assert_array_equal(got.asnumpy(), ref)
    mxt.nd.waitall()
    e = mxt.nd.empty((2, 2), ctx=mxt.cpu())
    onp.testing.assert_array_equal(e.asnumpy(),
                                   mx.nd.empty((2, 2)).asnumpy())
