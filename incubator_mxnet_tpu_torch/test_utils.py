"""Test utilities (counterpart of ``incubator_mxnet_tpu/test_utils.py``):
the default context for tests, array comparisons, random shapes and
arrays, finite-difference gradients, and the operator sweep.

The sweep walks ``_sweep_table()``, a copy of the JAX package's table
trimmed to the operators the port has (same entry names, input specs and
options), over contexts and dtypes: ``op_consistency_sweep`` compares
forward results across ``ctx_list`` (for example ``[cpu(), gpu(0)]``: the
CPU against the card) in float32, bfloat16 and float16 at ``SWEEP_TOLS``;
``grad_consistency_sweep`` compares the gradients of ``sum(op)`` in
float32. Entries tagged "mm" (matrix products, convolutions) run with
TF32 off, the counterpart of the JAX package's "highest" matmul precision.
"""
from __future__ import annotations

import contextlib

import numpy as onp
import torch

from . import autograd
from . import ndarray as nd
from .context import cpu, current_context
from .ndarray import NDArray, rnn_param_size

__all__ = ["default_context", "set_default_context", "assert_almost_equal",
           "almost_equal", "rand_ndarray", "rand_shape_2d", "rand_shape_3d",
           "rand_shape_nd", "check_numeric_gradient", "numeric_grad", "same",
           "random_seed", "op_consistency_sweep", "grad_consistency_sweep",
           "SWEEP_TOLS", "SWEEP_TOLS_TRANS", "sweep_inputs",
           "check_consistency", "simple_forward"]

_default_ctx = [None]


def default_context():
    return _default_ctx[0] if _default_ctx[0] is not None \
        else current_context()


def set_default_context(ctx):
    _default_ctx[0] = ctx


def _as_np(x):
    if isinstance(x, NDArray) or hasattr(x, "stype"):
        return x.asnumpy()             # sparse storage: its dense values
    if isinstance(x, torch.Tensor):
        return NDArray(x).asnumpy()
    return onp.asarray(x)


def same(a, b):
    return onp.array_equal(_as_np(a), _as_np(b))


def almost_equal(a, b, rtol=1e-5, atol=1e-20, equal_nan=False):
    return onp.allclose(_as_np(a), _as_np(b), rtol=rtol, atol=atol,
                        equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b"),
                        equal_nan=False):
    a, b = _as_np(a), _as_np(b)
    if not onp.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan):
        index = onp.unravel_index(onp.argmax(onp.abs(a - b)), a.shape) \
            if a.shape else ()
        rel = onp.abs(a - b) / (onp.abs(b) + atol + 1e-30)
        raise AssertionError(
            "Error %f exceeds tolerance rtol=%g atol=%g. Worst at %s: %s vs %s"
            % (float(rel.max()) if rel.size else 0.0, rtol, atol, index,
               a[index] if a.shape else a, b[index] if b.shape else b))


def rand_shape_2d(dim0=10, dim1=10):
    return tuple(onp.random.randint(1, d + 1) for d in (dim0, dim1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return tuple(onp.random.randint(1, d + 1) for d in (dim0, dim1, dim2))


def rand_shape_nd(num_dim, dim=10):
    return tuple(onp.random.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, stype="default", density=None, dtype="float32",
                 ctx=None, scale=1.0):
    """Uniform in (-scale, scale); for "row_sparse" each row, for "csr"
    each entry kept with probability ``density`` (default 0.5)."""
    dense = onp.random.uniform(-scale, scale, size=shape).astype(dtype)
    ctx = ctx if ctx is not None else default_context()
    if stype == "default":
        return nd.array(dense, ctx=ctx)
    if density is None:
        density = 0.5
    if stype == "row_sparse":
        rows = onp.random.rand(shape[0]) < density
        dense = dense * rows.reshape((-1,) + (1,) * (len(shape) - 1))
    elif stype == "csr":
        dense = dense * (onp.random.rand(*shape) < density)
    else:
        raise ValueError("unknown stype %r" % stype)
    return nd.array(dense, ctx=ctx).tostype(stype)


def numeric_grad(f, xs, eps=1e-4):
    """Central finite differences of the scalar ``f(xs)`` over a list of
    numpy arrays (changed in place and restored)."""
    grads = []
    for x in xs:
        g = onp.zeros_like(x, dtype=onp.float64)
        flat = x.reshape(-1)
        gf = g.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = float(f(xs))
            flat[j] = orig - eps
            fm = float(f(xs))
            flat[j] = orig
            gf[j] = (fp - fm) / (2 * eps)
        grads.append(g.astype(x.dtype))
    return grads


def check_numeric_gradient(fn, inputs, rtol=1e-2, atol=1e-3, eps=1e-3,
                           ctx=None):
    """``fn``'s autograd gradient (of the sum of its output) against finite
    differences, on ``ctx`` (default: ``default_context()``)."""
    ctx = ctx if ctx is not None else default_context()
    xs = [onp.asarray(x, dtype=onp.float64) for x in inputs]

    def f(arrs):
        vals = [nd.array(a.astype(onp.float32), ctx=ctx) for a in arrs]
        return fn(*vals).sum().asscalar()

    expected = numeric_grad(f, xs, eps)
    arrs = [nd.array(x.astype(onp.float32), ctx=ctx) for x in xs]
    for a in arrs:
        a.attach_grad()
    with autograd.record():
        out = fn(*arrs).sum()
    out.backward()
    for a, e in zip(arrs, expected):
        assert_almost_equal(a.grad.asnumpy(), e.astype(onp.float32),
                            rtol=rtol, atol=atol)


def simple_forward(sym_or_fn, ctx=None, is_train=False, **inputs):
    """``sym_or_fn(**inputs)`` on NDArrays made from the numpy ``inputs``
    (on ``ctx``, default the current context), as numpy: one array, or a
    list for several outputs."""
    outs = sym_or_fn(**{k: nd.array(v, ctx=ctx) for k, v in inputs.items()})
    if isinstance(outs, (list, tuple)):
        return [o.asnumpy() for o in outs]
    return outs.asnumpy()


def check_consistency(fn, inputs, ctx_list=None, dtypes=("float32",),
                      rtol=1e-3, atol=1e-4):
    """``fn`` on the numpy ``inputs`` in every context of ``ctx_list``
    (default: the CPU and ``default_context()``) and every dtype: each
    result, as float32, within ``rtol``/``atol`` of the first."""
    if ctx_list is None:
        ctx_list = [cpu(0), default_context()]
    results = []
    for ctx in ctx_list:
        for dt in dtypes:
            with ctx:
                arrs = [nd.array(onp.asarray(x, dtype=dt), ctx=ctx)
                        for x in inputs]
                results.append(_as_np(fn(*arrs)).astype("float32"))
    for r in results[1:]:
        assert_almost_equal(r, results[0], rtol=rtol, atol=atol)


# ================================================================== sweep

def _sweep_table():
    """The JAX package's sweep table (``test_utils._sweep_table``) trimmed
    to the operators the port has: entries (name[@tag], fn(M, *arrays),
    input specs, opts), with the same names, specs and opts. ``M`` is the
    ``nd`` namespace the operator is drawn from. Spec kinds: 'f' float in
    (-2, 2), 'pos' |f|+0.5, 'unit' (-0.9, 0.9), 'gt1' |f|+1.5, 'perm'
    distinct floats, 'b' 0/1 floats, ('i', hi) int32 in [0, hi), 'lenN'
    float lengths in [1, N], ((array,), 'const') that array. opts:
    'op' (the operator's name when the entry's differs), 'nondiff' (no
    gradient walk)."""

    def f(*shape):
        return (shape, "f")

    def pos(*shape):
        return (shape, "pos")

    def idx(*shape, hi=4):
        return (shape, ("i", hi))

    def mk(name, *specs, call=None, tag=None, **opts):
        entry = name if tag is None else name + "@" + tag
        if call is None:
            def call(M, *a, _n=name):
                return getattr(M, _n)(*a)
        return (entry, call, list(specs), opts)

    def kw(name, kwargs, *specs, tag=None, **opts):
        def call(M, *a, _n=name, _k=kwargs):
            return getattr(M, _n)(*a, **_k)
        return ((name if tag is None else name + "@" + tag), call,
                list(specs), opts)

    t = []
    # unary elementwise
    UNARY_F = ["abs", "sign", "square", "sin", "cos", "tan", "arctan",
               "sinh", "cosh", "tanh", "arcsinh", "sigmoid", "relu",
               "softsign", "erf", "negative", "identity", "zeros_like",
               "ones_like", "BlockGrad", "stop_gradient", "make_loss",
               "hard_sigmoid", "degrees", "radians", "exp", "expm1",
               "logical_not", "flatten"]
    UNARY_ND = ["round", "rint", "fix", "ceil", "floor", "trunc", "sign",
                "logical_not"]
    UNARY_POS = ["sqrt", "rsqrt", "cbrt", "rcbrt", "log", "log10", "log2",
                 "log1p", "reciprocal", "gamma", "gammaln", "digamma"]
    UNARY_UNIT = ["arcsin", "arccos", "arctanh", "erfinv"]
    TRANS = {"exp", "expm1", "log", "log10", "log2", "log1p", "sqrt",
             "rsqrt", "cbrt", "rcbrt", "sin", "cos", "tan", "arcsin",
             "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
             "arccosh", "arctanh", "sigmoid", "softsign", "erf", "erfinv",
             "gamma", "gammaln", "digamma", "reciprocal", "power",
             "hypot", "arctan2", "norm", "softmax", "log_softmax",
             "softmin"}
    for n in UNARY_F:
        t.append(mk(n, f(4, 16), tag="trans" if n in TRANS else None,
                    nondiff=n in UNARY_ND))
    for n in UNARY_ND:
        if n not in UNARY_F:
            t.append(mk(n, f(4, 16), nondiff=True))
    for n in UNARY_POS:
        t.append(mk(n, pos(4, 16), tag="trans"))
    for n in UNARY_UNIT:
        t.append(mk(n, ((4, 16), "unit"), tag="trans"))
    t.append(mk("arccosh", ((4, 16), "gt1"), tag="trans"))
    t.append(kw("clip", dict(a_min=-1.0, a_max=1.0), f(4, 16)))
    t.append(kw("smooth_l1", dict(scalar=1.0), f(4, 16)))
    t.append(kw("IdentityAttachKLSparseReg", dict(sparseness_target=0.1),
                ((4, 16), "unit")))
    t.append(kw("cast", dict(dtype="float16"), f(4, 16)))
    t.append(kw("Cast", dict(dtype="float16"), f(4, 16)))
    t.append(kw("amp_cast", dict(dtype="float16"), f(4, 16)))
    t.append(mk("amp_multicast", f(4, 16), f(4, 16),
                call=lambda M, a, b: M.amp_multicast(a, b, num_outputs=2)))

    # binary elementwise
    BIN_FF = ["add", "subtract", "multiply", "maximum", "minimum",
              "hypot", "arctan2", "elemwise_add", "elemwise_sub",
              "elemwise_mul"]
    BIN_FPOS = ["divide", "true_divide", "mod", "modulo", "elemwise_div"]
    BIN_CMP = ["equal", "not_equal", "greater", "greater_equal", "lesser",
               "lesser_equal"]
    BIN_LOGIC = ["logical_and", "logical_or", "logical_xor"]
    for n in BIN_FF:
        t.append(mk(n, f(4, 16), f(4, 16),
                    tag="trans" if n in TRANS else None))
    for n in BIN_FPOS:
        t.append(mk(n, f(4, 16), pos(4, 16)))
    for n in BIN_CMP:
        t.append(mk(n, f(4, 16), f(4, 16), nondiff=True))
    for n in BIN_LOGIC:
        t.append(mk(n, ((4, 16), "b"), ((4, 16), "b"), nondiff=True))
    t.append(mk("power", pos(4, 16), f(4, 16), tag="trans"))

    # broadcast binary
    BCAST_FF = ["broadcast_add", "broadcast_plus", "broadcast_sub",
                "broadcast_minus", "broadcast_subtract", "broadcast_mul",
                "broadcast_multiply", "broadcast_maximum",
                "broadcast_minimum", "broadcast_hypot",
                "broadcast_arctan2"]
    BCAST_FPOS = ["broadcast_div", "broadcast_divide", "broadcast_mod",
                  "broadcast_modulo"]
    BCAST_CMP = ["broadcast_equal", "broadcast_not_equal",
                 "broadcast_greater", "broadcast_greater_equal",
                 "broadcast_lesser", "broadcast_lesser_equal"]
    BCAST_LOGIC = ["broadcast_logical_and", "broadcast_logical_or",
                   "broadcast_logical_xor"]
    for n in BCAST_FF:
        t.append(mk(n, f(4, 16), f(1, 16),
                    tag="trans" if n.replace("broadcast_", "") in TRANS
                    else None))
    for n in BCAST_FPOS:
        t.append(mk(n, f(4, 16), pos(1, 16)))
    for n in BCAST_CMP:
        t.append(mk(n, f(4, 16), f(1, 16), nondiff=True))
    for n in BCAST_LOGIC:
        t.append(mk(n, ((4, 16), "b"), ((1, 16), "b"), nondiff=True))
    t.append(mk("broadcast_power", pos(4, 16), f(1, 16), tag="trans"))

    # reductions
    for n in ["sum", "mean", "max", "min"]:
        t.append(kw(n, dict(axis=1), f(8, 64)))
    t.append(kw("prod", dict(axis=1), f(8, 8)))
    t.append(kw("norm", dict(axis=1), f(8, 64), tag="trans"))
    t.append(kw("argmax", dict(axis=1), ((8, 64), "perm"), nondiff=True))
    t.append(kw("argmin", dict(axis=1), ((8, 64), "perm"), nondiff=True))
    t.append(kw("moments", dict(axes=1), f(8, 16)))

    # shape / layout
    t.append(kw("reshape", dict(shape=(8, 8)), f(4, 16)))
    t.append(mk("reshape_like", f(4, 16), f(8, 8)))
    t.append(kw("transpose", dict(axes=(1, 0, 2)), f(3, 4, 5)))
    t.append(kw("swapaxes", dict(dim1=0, dim2=1), f(3, 4, 5)))
    t.append(kw("SwapAxis", dict(dim1=0, dim2=1), f(3, 4, 5)))
    t.append(kw("expand_dims", dict(axis=1), f(4, 16)))
    t.append(kw("squeeze", dict(axis=1), f(4, 1, 16)))
    t.append(kw("tile", dict(reps=(2, 2)), f(3, 4)))
    t.append(kw("repeat", dict(repeats=2, axis=1), f(3, 4)))
    t.append(kw("pad", dict(mode="constant",
                            pad_width=(0, 0, 0, 0, 1, 1, 1, 1)),
                f(2, 3, 4, 4)))
    t.append(kw("flip", dict(axis=1), f(3, 4)))
    t.append(kw("reverse", dict(axis=1), f(3, 4)))
    t.append(kw("depth_to_space", dict(block_size=2), f(1, 8, 3, 3)))
    t.append(kw("space_to_depth", dict(block_size=2), f(1, 2, 6, 6)))
    t.append(kw("diag", dict(k=0), f(5, 5)))
    t.append(kw("moveaxis", dict(source=0, destination=1), f(3, 4, 5)))
    t.append(kw("broadcast_to", dict(shape=(4, 16)), f(1, 16)))
    t.append(mk("broadcast_like", f(1, 16), f(4, 16)))
    t.append(kw("broadcast_axis", dict(axis=0, size=4), f(1, 16)))
    t.append(kw("slice", dict(begin=(1, 2), end=(3, 10)), f(4, 16)))
    t.append(kw("slice_axis", dict(axis=1, begin=2, end=10), f(4, 16)))
    t.append(mk("slice_like", f(8, 16), f(4, 8)))
    t.append(kw("split", dict(num_outputs=2, axis=1), f(4, 16)))
    t.append(kw("SliceChannel", dict(num_outputs=2, axis=1), f(4, 16)))
    t.append(kw("split_v2", dict(indices_or_sections=2, axis=1), f(4, 16)))
    t.append(kw("stack", dict(axis=0), f(3, 4), f(3, 4)))
    t.append(kw("concat", dict(dim=1), f(4, 8), f(4, 8)))
    t.append(kw("Concat", dict(dim=1), f(4, 8), f(4, 8)))
    t.append(mk("concatenate", f(4, 8), f(4, 8),
                call=lambda M, a, b: M.concatenate([a, b], axis=0)))
    t.append(kw("arange_like", dict(start=0.0, step=1.0), f(4, 16),
                nondiff=True))
    t.append(mk("shape_array", f(4, 16), nondiff=True))
    t.append(mk("size_array", f(4, 16), nondiff=True))
    t.append(mk("add_n", f(4, 16), f(4, 16), f(4, 16)))

    # indexing / ordering
    t.append(mk("take", f(16, 8), idx(6, hi=16)))
    t.append(kw("pick", dict(axis=-1), f(4, 16), idx(4, hi=16)))
    t.append(kw("one_hot", dict(depth=16), idx(6, hi=16), nondiff=True))
    t.append(mk("gather_nd", f(5, 5), idx(2, 4, hi=5)))
    t.append(kw("scatter_nd", dict(shape=(5, 5)), f(4), idx(2, 4, hi=5)))
    t.append(mk("batch_take", f(4, 8), idx(4, hi=8)))
    t.append(kw("topk", dict(k=3, ret_typ="value"), ((4, 16), "perm")))
    t.append(kw("sort", dict(axis=-1), ((4, 16), "perm")))
    t.append(kw("argsort", dict(axis=-1), ((4, 16), "perm"), nondiff=True))
    t.append(mk("where", ((4, 16), "b"), f(4, 16), f(4, 16)))

    # matmul-class
    t.append(mk("dot", f(8, 32), f(32, 8), tag="mm"))
    t.append(mk("batch_dot", f(2, 8, 16), f(2, 16, 8), tag="mm"))
    t.append(mk("khatri_rao", f(4, 8), f(3, 8), tag="mm"))
    t.append(kw("trace", dict(offset=0, axis1=0, axis2=1), f(6, 6)))

    # nn layers already on the port's paths
    t.append(mk("FullyConnected", f(4, 32), f(8, 32), f(8), tag="mm",
                call=lambda M, x, w, b: M.FullyConnected(x, w, b,
                                                         num_hidden=8)))
    t.append(mk("Convolution", f(2, 4, 8, 8), f(8, 4, 3, 3), tag="mm",
                call=lambda M, x, w: M.Convolution(
                    x, w, None, kernel=(3, 3), num_filter=8, pad=(1, 1),
                    no_bias=True)))
    t.append(mk("Pooling", f(2, 4, 8, 8),
                call=lambda M, x: M.Pooling(x, kernel=(2, 2),
                                            pool_type="max", stride=(2, 2))))
    t.append(mk("Pooling_avg", f(2, 4, 8, 8), op="Pooling",
                call=lambda M, x: M.Pooling(x, kernel=(2, 2),
                                            pool_type="avg", stride=(2, 2))))
    t.append(mk("Deconvolution", f(2, 4, 8, 8), f(4, 8, 3, 3), tag="mm",
                call=lambda M, x, w: M.Deconvolution(
                    x, w, None, kernel=(3, 3), num_filter=8, pad=(1, 1),
                    no_bias=True)))
    t.append(mk("BatchNorm", f(2, 4, 8, 8), f(4), pos(4), f(4), pos(4),
                call=lambda M, x, g, b, mm, mv: M.BatchNorm(
                    x, g, b, mm, mv, fix_gamma=False,
                    use_global_stats=True)))
    t.append(mk("LayerNorm", f(4, 16), f(16), f(16),
                call=lambda M, x, g, b: M.LayerNorm(x, g, b, axis=-1)))
    t.append(mk("GroupNorm", f(2, 4, 8, 8), f(4), f(4),
                call=lambda M, x, g, b: M.GroupNorm(x, g, b, num_groups=2)))
    t.append(mk("InstanceNorm", f(2, 4, 8, 8), f(4), f(4)))
    t.append(kw("Dropout", dict(p=0.0), f(4, 16)))
    t.append(kw("Activation", dict(act_type="softrelu"), f(4, 16),
                tag="trans"))
    t.append(kw("LeakyReLU", dict(act_type="leaky", slope=0.1), f(4, 16)))
    for n in ["softmax", "log_softmax"]:
        t.append(kw(n, dict(axis=-1), f(4, 16), tag="trans"))
    t.append(mk("Embedding", idx(6, hi=16), f(16, 8),
                call=lambda M, i, w: M.Embedding(i, w, input_dim=16,
                                                 output_dim=8)))

    # the spatial operators of ops/detection.py
    t.append(kw("ROIPooling", dict(pooled_size=(2, 2), spatial_scale=1.0),
                f(1, 3, 8, 8),
                ((onp.array([[0, 0, 0, 4, 4], [0, 1, 1, 6, 6]],
                            dtype="float32"),), "const")))
    t.append(mk("BilinearSampler", f(1, 2, 6, 6), ((1, 2, 4, 4), "unit")))
    t.append(kw("GridGenerator", dict(transform_type="affine",
                                      target_shape=(4, 4)),
                ((2, 6), "unit")))
    t.append(kw("SpatialTransformer",
                dict(target_shape=(4, 4), transform_type="affine",
                     sampler_type="bilinear"),
                f(1, 2, 8, 8), ((1, 6), "unit")))

    _rnn_n = rnn_param_size("rnn_tanh", 4, 8, 1)
    t.append(mk("RNN", f(3, 2, 4), f(_rnn_n), f(1, 2, 8), tag="trans",
                call=lambda M, x, p, s: M.RNN(x, p, s, state_size=8,
                                              num_layers=1,
                                              mode="rnn_tanh")))

    # sequence family (float lengths, mask semantics)
    for n in ("sequence_mask", "SequenceMask", "SequenceLast",
              "SequenceReverse"):
        t.append(kw(n, dict(use_sequence_length=True), f(5, 3, 4),
                    ((3,), "len5"), nondiff=True))

    # creation (nullary)
    t.append(mk("zeros", call=lambda M: M.zeros((3, 4)), nondiff=True))
    t.append(mk("ones", call=lambda M: M.ones((3, 4)), nondiff=True))
    t.append(mk("full", call=lambda M: M.full((3, 4), 2.5), nondiff=True))
    t.append(mk("eye", call=lambda M: M.eye(4), nondiff=True))
    t.append(mk("arange", call=lambda M: M.arange(0, 8), nondiff=True))
    t.append(mk("linspace", call=lambda M: M.linspace(0.0, 1.0, 5),
                nondiff=True))
    # the loss layers, nn-style operators, index operators, linear algebra
    # and legacy aliases
    t.append(mk("all_finite", f(4, 16), nondiff=True))
    t.append(mk("multi_all_finite", f(4, 16), f(4, 16), nondiff=True,
                call=lambda M, a, b: M.multi_all_finite(a, b, num_arrays=2)))
    t.append(mk("multi_sum_sq", f(4, 16), f(4, 16),
                call=lambda M, a, b: M.multi_sum_sq(a, b, num_arrays=2)))
    t.append(mk("multi_lars", pos(4), pos(4), pos(4), pos(4),
                call=lambda M, lr, w, g, wd: M.multi_lars(
                    lr, w, g, wd, eta=0.001), nondiff=True))
    t.append(kw("Crop", dict(offset=(1, 1), h_w=(4, 4), num_args=1),
                f(1, 2, 8, 8)))
    t.append(mk("meshgrid", f(4), f(5)))
    t.append(mk("argmax_channel", ((4, 16), "perm"), nondiff=True))
    t.append(kw("unravel_index", dict(shape=(4, 6)), idx(6, hi=24),
                nondiff=True))
    t.append(kw("ravel_multi_index", dict(shape=(4, 6)), idx(2, 6, hi=4),
                nondiff=True))
    t.append(mk("onehot_encode", idx(6, hi=8), f(6, 8), nondiff=True))
    t.append(kw("histogram", dict(bins=5, range=(-2.0, 2.0)), f(64),
                nondiff=True))
    t.append(mk("linalg.gemm2", f(8, 32), f(32, 8), tag="mm",
                call=lambda M, a, b: M.linalg.gemm2(a, b),
                op="linalg.gemm2"))
    t.append(mk("Convolution_v1", f(2, 4, 8, 8), f(8, 4, 3, 3), tag="mm",
                call=lambda M, x, w: M.Convolution_v1(
                    x, w, None, kernel=(3, 3), num_filter=8, pad=(1, 1),
                    no_bias=True)))
    t.append(mk("Pooling_v1", f(2, 4, 8, 8),
                call=lambda M, x: M.Pooling_v1(x, kernel=(2, 2),
                                               pool_type="max",
                                               stride=(2, 2))))
    for bn_name in ["BatchNorm_v1", "CuDNNBatchNorm"]:
        t.append(mk(bn_name, f(2, 4, 8, 8), f(4), pos(4), f(4), pos(4),
                    call=lambda M, x, g, b, mm, mv, _n=bn_name: getattr(M, _n)(
                        x, g, b, mm, mv, fix_gamma=False,
                        use_global_stats=True)))
    t.append(kw("SoftmaxActivation", dict(mode="instance"), f(4, 16),
                tag="trans"))
    t.append(kw("softmin", dict(axis=-1), f(4, 16), tag="trans"))
    t.append(mk("softmax_cross_entropy", f(4, 16), idx(4, hi=16),
                tag="trans"))
    t.append(mk("SoftmaxOutput", f(4, 8), idx(4, hi=8), tag="trans"))
    t.append(mk("LinearRegressionOutput", f(4, 8), f(4, 8)))
    t.append(mk("LogisticRegressionOutput", f(4, 8), ((4, 8), "b"),
                tag="trans"))
    t.append(mk("MAERegressionOutput", f(4, 8), f(4, 8)))
    t.append(mk("CTCLoss", f(6, 2, 5), ((2, 3), ("i1", 5)), tag="trans"))
    t.append(mk("ctc_loss", f(6, 2, 5), ((2, 3), ("i1", 5)), tag="trans"))
    t.append(kw("L2Normalization", dict(mode="instance"), f(4, 16)))
    t.append(kw("LRN", dict(nsize=3), f(2, 4, 6, 6)))
    t.append(kw("UpSampling", dict(scale=2, sample_type="nearest"),
                f(1, 2, 4, 4)))
    t.append(kw("BilinearResize2D", dict(height=6, width=6), f(1, 2, 4, 4)))
    t.append(kw("Correlation", dict(kernel_size=1, max_displacement=2),
                f(2, 3, 8, 8), f(2, 3, 8, 8)))
    t.append(kw("im2col", dict(kernel=(3, 3), pad=(1, 1)), f(2, 3, 8, 8)))
    t.append(kw("col2im", dict(output_size=(8, 8), kernel=(3, 3),
                               pad=(1, 1)), f(2, 27, 64)))

    # the optimizer update operators (nondiff: the update rule itself);
    # accumulator states positive
    OPT2 = {"sgd_update": "fg", "signsgd_update": "fg",
            "mp_sgd_update": "fgf", "sgd_mom_update": "fgf",
            "signum_update": "fgf", "nag_mom_update": "fgf",
            "mp_sgd_mom_update": "fgff", "mp_nag_mom_update": "fgff",
            "rmsprop_update": "fgp", "adam_update": "fgfp",
            "ftrl_update": "fgfp", "ftml_update": "fgfpf"}
    for n, kinds in OPT2.items():
        specs = [f(4, 8) if k in "fg" else pos(4, 8) for k in kinds]
        t.append(mk(n, *specs, nondiff=True,
                    call=lambda M, *a, _n=n: getattr(M, _n)(*a, lr=0.1)))
    # centred RMSProp: n - g² > 0 under the sqrt
    t.append(mk("rmspropalex_update", f(4, 8), f(4, 8), ((4, 8), "gt1"),
                ((4, 8), "unit"), f(4, 8), nondiff=True,
                call=lambda M, w, g, n_, gs, d: M.rmspropalex_update(
                    w, g, n_, gs, d, lr=0.1)))
    for n in ["lamb_update_phase1", "mp_lamb_update_phase1"]:
        t.append(mk(n, f(4, 8), f(4, 8), f(4, 8), pos(4, 8), nondiff=True,
                    call=lambda M, w, g, m, v, _n=n: getattr(M, _n)(
                        w, g, m, v, t=1)))
    for n in ["lamb_update_phase2", "mp_lamb_update_phase2"]:
        t.append(mk(n, f(4, 8), f(4, 8), pos(1), pos(1), nondiff=True,
                    call=lambda M, w, g, r1, r2, _n=n: getattr(M, _n)(
                        w, g, r1, r2, lr=0.1)))
    t.append(mk("multi_sgd_update", f(4, 8), f(4, 8), nondiff=True,
                call=lambda M, w, g: M.multi_sgd_update(
                    [w], [g], lrs=[0.1], wds=[0.0])))
    t.append(mk("multi_sgd_mom_update", f(4, 8), f(4, 8), f(4, 8),
                nondiff=True,
                call=lambda M, w, g, m: M.multi_sgd_mom_update(
                    [w], [g], [m], lrs=[0.1], wds=[0.0])))
    t.append(mk("multi_mp_sgd_update", f(4, 8), f(4, 8), f(4, 8),
                nondiff=True,
                call=lambda M, w, g, w32: M.multi_mp_sgd_update(
                    [w], [g], [w32], lrs=[0.1], wds=[0.0])))
    t.append(mk("multi_mp_sgd_mom_update", f(4, 8), f(4, 8), f(4, 8),
                f(4, 8), nondiff=True,
                call=lambda M, w, g, m, w32: M.multi_mp_sgd_mom_update(
                    [w], [g], [m], [w32], lrs=[0.1], wds=[0.0])))
    t.append(mk("preloaded_multi_sgd_update", f(4, 8), f(4, 8), pos(1),
                pos(1), nondiff=True,
                call=lambda M, w, g, lr, wd: M.preloaded_multi_sgd_update(
                    [w], [g], lr, wd)))
    t.append(mk("preloaded_multi_sgd_mom_update", f(4, 8), f(4, 8),
                f(4, 8), pos(1), pos(1), nondiff=True,
                call=lambda M, w, g, m, lr, wd:
                M.preloaded_multi_sgd_mom_update([w], [g], [m], lr, wd)))
    t.append(mk("preloaded_multi_mp_sgd_update", f(4, 8), f(4, 8), f(4, 8),
                pos(1), pos(1), nondiff=True,
                call=lambda M, w, g, w32, lr, wd:
                M.preloaded_multi_mp_sgd_update([w], [g], [w32], lr, wd)))
    t.append(mk("preloaded_multi_mp_sgd_mom_update", f(4, 8), f(4, 8),
                f(4, 8), f(4, 8), pos(1), pos(1), nondiff=True,
                call=lambda M, w, g, m, w32, lr, wd:
                M.preloaded_multi_mp_sgd_mom_update([w], [g], [m], [w32],
                                                    lr, wd)))
    # sparse storage, compared dense
    t.append(mk("cast_storage", f(4, 16), nondiff=True, sym=False,
                symreason="sparse storage is eager-only (README Sparse)",
                call=lambda M, a: M.cast_storage(a, "row_sparse")))
    return t


#: (rtol, atol) by dtype; "trans"-tagged entries (transcendentals) take the
#: looser float32 row, as in the JAX package.
SWEEP_TOLS = {"float32": (1e-4, 1e-5), "bfloat16": (4e-2, 2e-2),
              "float16": (1e-2, 2e-3)}
SWEEP_TOLS_TRANS = {"float32": (2e-3, 1e-4), "bfloat16": (4e-2, 2e-2),
                    "float16": (1e-2, 2e-3)}
#: nondiff entries that still take the low-precision dtype legs
TRANS_DTYPE_OK = {"round", "floor", "ceil", "trunc", "rint", "fix", "sign"}
_FLOAT_KINDS = ("f", "pos", "unit", "gt1", "perm", "pmf")


def _gen_input(rng, shape, kind):
    if kind == "const":
        return shape[0].copy()          # the spec carries the array
    if isinstance(kind, tuple):
        if kind[0] == "i":
            return rng.randint(0, kind[1], size=shape).astype("int32")
        if kind[0] == "i1":
            return rng.randint(1, kind[1], size=shape).astype("int32")
        raise ValueError("unknown spec kind %r" % (kind,))
    if kind == "b":
        return rng.randint(0, 2, size=shape).astype("float32")
    if kind == "perm":
        n = int(onp.prod(shape)) if shape else 1
        return (rng.permutation(n).astype("float32") / n).reshape(shape)
    if kind.startswith("len"):
        return rng.randint(1, int(kind[3:] or 4) + 1,
                           size=shape).astype("float32")
    a = rng.uniform(-2.0, 2.0, size=shape).astype("float32")
    if kind == "pos":
        a = onp.abs(a) + 0.5
    elif kind == "unit":
        a = onp.clip(a * 0.45, -0.9, 0.9)
    elif kind == "gt1":
        a = onp.abs(a) + 1.5
    return a


def sweep_inputs(specs, seed=0):
    """The inputs of an entry, made from ``seed`` as the JAX package's."""
    rng = onp.random.RandomState(seed)
    return [_gen_input(rng, shape, kind) for shape, kind in specs]


def _norm_outputs(o):
    outs = o if isinstance(o, (list, tuple)) else [o]
    return [_as_np(x).astype("float32") for x in outs]


#: entries whose products run on cuDNN but are not tagged "mm": cuDNN's
#: RNN takes TF32 for float32 as its convolutions do
_CUDNN_PRODUCTS = {"RNN"}


def _tf32_off(name, tag):
    """Whether an entry's legs run with TF32 off (``_full_precision``)."""
    return tag == "mm" or name in _CUDNN_PRODUCTS


@contextlib.contextmanager
def _full_precision(on):
    """TF32 off for matmuls and cuDNN convolutions and RNNs while ``on``."""
    if not on:
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _sweep_arrays(specs, inputs, ctx, dt):
    arrs = []
    for (_, kind), x in zip(specs, inputs):
        a = nd.array(x, ctx=ctx)
        if kind in _FLOAT_KINDS and dt != "float32":
            a = a.astype(dt)
        arrs.append(a)
    return arrs


def op_consistency_sweep(dtypes=("float32", "bfloat16", "float16"),
                         ctx_list=None, quick=False, seed=0):
    """Every entry of ``_sweep_table()`` under each context and dtype, each
    leg's outputs against the first context's. Returns rows (op, dtype,
    max relative error, status), status "ok", "MISMATCH" or "ERROR: ...".
    A nondiff entry runs only the first dtype (but the rounding family)."""
    table = _sweep_table()
    if quick:
        table = table[::6]
    if ctx_list is None:
        ctx_list = [cpu(0), default_context()]
    rows = []
    for entry_name, fn, specs, opts in table:
        name, _, tag = entry_name.partition("@")
        inputs = sweep_inputs(specs, seed)
        for dt in dtypes:
            if dt != dtypes[0] and opts.get("nondiff") \
                    and name not in TRANS_DTYPE_OK:
                continue
            rtol, atol = (SWEEP_TOLS_TRANS if tag == "trans"
                          else SWEEP_TOLS)[dt]
            try:
                outs = []
                with _full_precision(_tf32_off(name, tag)):
                    for ctx in ctx_list:
                        arrs = _sweep_arrays(specs, inputs, ctx, dt)
                        with ctx:
                            outs.append(_norm_outputs(fn(nd, *arrs)))
                err, ok = 0.0, True
                for legs in outs[1:]:
                    for r, b in zip(legs, outs[0]):
                        diff = onp.abs(r - b)
                        err = max(err, float(
                            (diff / (onp.abs(b) + atol)).max())
                            if diff.size else 0.0)
                        ok = ok and r.shape == b.shape and onp.allclose(
                            r, b, rtol=rtol, atol=atol)
                rows.append((name, dt, err, "ok" if ok else "MISMATCH"))
            except Exception as e:  # noqa: BLE001 — recorded; walk on
                rows.append((name, dt, None, "ERROR: %s"
                             % str(e).splitlines()[0][:120]))
    return rows


def _grad_entries():
    out = []
    for name, fn, specs, opts in _sweep_table():
        if opts.get("nondiff") or not specs:
            continue
        if all(kind in _FLOAT_KINDS for _, kind in specs):
            out.append((name, fn, specs, opts))
    return out


def grad_consistency_sweep(ctx_list=None, quick=False, seed=0):
    """The float32 gradients of ``sum(op)`` (summed over its outputs) for
    every differentiable entry with float inputs, each context's against
    the first's. Returns rows (op, max relative error, status)."""
    table = _grad_entries()
    if quick:
        table = table[::6]
    if ctx_list is None:
        ctx_list = [cpu(0), default_context()]
    rows = []
    for entry_name, fn, specs, opts in table:
        name, _, tag = entry_name.partition("@")
        inputs = sweep_inputs(specs, seed)
        rtol, atol = (2e-3, 1e-4) if tag == "trans" else (1e-4, 1e-5)
        try:
            grads = []
            with _full_precision(_tf32_off(name, tag)):
                for ctx in ctx_list:
                    grads.append(_sum_grads(fn, inputs, ctx))
            err, ok = 0.0, True
            for g in grads[1:]:
                for a, b in zip(g, grads[0]):
                    diff = onp.abs(a - b)
                    err = max(err, float(
                        (diff / (onp.abs(b) + atol)).max())
                        if diff.size else 0.0)
                    ok = ok and onp.allclose(a, b, rtol=rtol, atol=atol)
            rows.append((name, err, "ok" if ok else "MISMATCH"))
        except Exception as e:  # noqa: BLE001 — recorded; walk on
            rows.append((name, None,
                         "ERROR: %s" % str(e).splitlines()[0][:120]))
    return rows


def _sum_grads(fn, inputs, ctx):
    """d(sum of ``fn``'s outputs)/d(inputs) on ``ctx``, as numpy."""
    arrs = [nd.array(x, ctx=ctx) for x in inputs]
    for a in arrs:
        a.attach_grad()
    with ctx:
        with autograd.record():
            out = fn(nd, *arrs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            s = outs[0].sum()
            for x in outs[1:]:
                s = s + x.sum()
        s.backward()
    return [a.grad.asnumpy() for a in arrs]



class random_seed:
    """Fix numpy's and ``nd.random``'s seeds inside the scope (a random
    seed when None); numpy's state is restored on exit."""

    def __init__(self, seed=None):
        self.seed = seed
        self._np_state = None

    def __enter__(self):
        self._np_state = onp.random.get_state()
        s = self.seed if self.seed is not None \
            else onp.random.randint(0, 2 ** 31)
        onp.random.seed(s)
        nd.random.seed(s)
        return s

    def __exit__(self, *a):
        onp.random.set_state(self._np_state)
