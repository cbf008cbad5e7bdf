"""ONNX export and import (counterpart of
``incubator_mxnet_tpu/contrib/onnx.py``; MXNet's contrib/onnx mx2onnx and
onnx2mx).

It writes and reads ``.onnx`` files itself through ``onnx_proto`` (no
``onnx`` package): standard ModelProto, IR 8, opset 17 (the floor of
LayerNormalization). ``export_model`` walks the port's ``Symbol`` and emits
the reference's node names, attribute order and initializer bytes, so a
file either package writes is read by both; ``import_model`` maps ONNX
nodes back onto ``mx.sym`` operators.

The operators: the model-zoo CNN surface (Conv, Gemm/FullyConnected,
BatchNormalization, Relu/Sigmoid/Tanh/Softplus, the max/average/global
pools, Flatten, Softmax, Dropout, Concat, Add/Sub/Mul/Div, MatMul,
Exp/Log/Sqrt/Neg/Abs, Reshape, Transpose, Clip) and the transformer/RNN
surface (Embedding↔Gather, LayerNorm↔LayerNormalization, batch_dot↔MatMul
with transpose fix-ups, gelu↔its Erf decomposition, LeakyRelu/Elu/Selu/
PRelu, Where, Erf, Unsqueeze/Squeeze, Slice, Cast, Pow, scalar arithmetic,
and the fused RNN op ↔ ONNX LSTM/GRU/RNN nodes with the cuDNN ifgo → ONNX
iofc gate repacking). Limits, as in the reference: no resize, no boolean
reductions; RNN export needs the packed parameter vector as an
initializer and ``state_outputs=False``.
"""
from __future__ import annotations

import numpy as onp

from . import onnx_proto as P

__all__ = ["export_model", "import_model", "get_model_metadata"]

_ACT = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
        "softrelu": "Softplus"}
_ELEM = {"add": "Add", "elemwise_add": "Add", "broadcast_add": "Add",
         "subtract": "Sub", "elemwise_sub": "Sub", "broadcast_sub": "Sub",
         "multiply": "Mul", "elemwise_mul": "Mul", "broadcast_mul": "Mul",
         "divide": "Div", "elemwise_div": "Div", "broadcast_div": "Div",
         "_plus": "Add", "_minus": "Sub", "_mul": "Mul", "_div": "Div",
         "_pow": "Pow", "power": "Pow", "broadcast_power": "Pow",
         "maximum": "Max", "_maximum": "Max", "broadcast_maximum": "Max",
         "minimum": "Min", "_minimum": "Min", "broadcast_minimum": "Min"}
_UNARY = {"exp": "Exp", "log": "Log", "sqrt": "Sqrt", "negative": "Neg",
          "abs": "Abs", "relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
          "identity": "Identity", "flatten": "Flatten", "erf": "Erf"}
_SCALAR = {"_plus_scalar": "Add", "_minus_scalar": "Sub",
           "_mul_scalar": "Mul", "_div_scalar": "Div",
           "_power_scalar": "Pow", "_pow_scalar": "Pow"}
# comparisons return float 0/1 masks in mx semantics; exported as the ONNX
# bool comparison + Cast back to float so downstream arithmetic stays valid
_CMP_SCALAR = {"_greater_scalar": "Greater", "_lesser_scalar": "Less",
               "_greater_equal_scalar": "GreaterOrEqual",
               "_lesser_equal_scalar": "LessOrEqual",
               "_equal_scalar": "Equal", "_not_equal_scalar": None}
_CMP = {"broadcast_greater": "Greater", "broadcast_lesser": "Less",
        "broadcast_greater_equal": "GreaterOrEqual",
        "broadcast_lesser_equal": "LessOrEqual",
        "broadcast_equal": "Equal",
        # Symbol operator sugar traces two-symbol comparisons as _greater
        # etc. (symbol/symbol.py __gt__/__ge__/__lt__/__le__)
        "_greater": "Greater", "_lesser": "Less",
        "_greater_equal": "GreaterOrEqual", "_lesser_equal": "LessOrEqual",
        "_equal": "Equal", "greater": "Greater", "lesser": "Less",
        "greater_equal": "GreaterOrEqual", "lesser_equal": "LessOrEqual",
        "equal": "Equal"}
# our cuDNN-layout gate order -> ONNX gate order, as a block permutation
# along the (G*H, *) axis:  lstm ifgo -> iofc;  gru rzn -> zrn (and ONNX
# linear_before_reset=1 matches the cuDNN recurrence we implement)
_GATE_PERM = {"lstm": (0, 3, 1, 2), "gru": (1, 0, 2),
              "rnn_relu": (0,), "rnn_tanh": (0,)}
_GATE_UNPERM = {m: tuple(onp.argsort(p)) for m, p in _GATE_PERM.items()}
_ONNX_RNN_OP = {"lstm": "LSTM", "gru": "GRU",
                "rnn_relu": "RNN", "rnn_tanh": "RNN"}


def export_model(sym, params, input_shape, input_type="float32",
                 onnx_file_path="model.onnx", verbose=False):
    """Symbol + params → .onnx file (ref mx2onnx/export_model.py).

    input_shape: one shape tuple (single data input) or list of tuples
    matching the non-parameter arguments in order.
    """
    from ..ndarray import NDArray

    if isinstance(input_shape, tuple):
        input_shape = [input_shape]
    params = {k.split(":", 1)[-1]: v for k, v in (params or {}).items()}

    nodes, initializers, extra_inits = [], [], {}
    fix_gamma_ones = []  # (ones_init_name, gamma_value_name) for BatchNorm
    arg_names = sym.list_arguments()
    data_names = [n for n in arg_names if n not in params]
    if len(data_names) != len(input_shape):
        raise ValueError("input_shape entries (%d) must match data inputs %s"
                         % (len(input_shape), data_names))

    # shape hints survive pops during emit (the RNN branch removes its
    # repacked parameter vector from params, but infer_shape still needs
    # every original shape)
    shape_hints = {k: tuple(v.shape) for k, v in params.items()}
    name_of = {}
    counter = [0]

    def fresh(prefix):
        counter[0] += 1
        return "%s_%d" % (prefix, counter[0])

    def emit(s):
        """Returns the output value name for node s."""
        base = getattr(s, "_base", None) or s
        if id(base) in name_of:
            return name_of[id(base)]
        if base.is_var:
            name_of[id(base)] = base.name
            return base.name
        ins = [emit(i) for i in base._inputs]
        op, kw = base._op_name, base._kwargs
        out = base.name
        if op == "FullyConnected":
            a = ins[0]
            if kw.get("flatten", True):
                f = fresh("flat")
                nodes.append(P.node("Flatten", [a], [f], f,
                                    [P.attr_int("axis", 1)]))
                a = f
                attrs = [P.attr_float("alpha", 1.0),
                         P.attr_float("beta", 1.0), P.attr_int("transB", 1)]
                gemm_in = [a, ins[1]] + (ins[2:3]
                                         if not kw.get("no_bias") else [])
                nodes.append(P.node("Gemm", gemm_in, [out], out, attrs))
            else:
                # ONNX Gemm is strictly 2-D; the flatten=False (rank-
                # preserving) FC becomes MatMul(x, W^T) + bias — runtimes
                # constant-fold the weight Transpose
                wt = fresh("fc_wT")
                nodes.append(P.node("Transpose", [ins[1]], [wt], wt,
                                    [P.attr_ints("perm", (1, 0))]))
                if kw.get("no_bias"):
                    nodes.append(P.node("MatMul", [a, wt], [out], out))
                else:
                    mm = fresh("fc_mm")
                    nodes.append(P.node("MatMul", [a, wt], [mm], mm))
                    nodes.append(P.node("Add", [mm, ins[2]], [out], out))
        elif op == "Convolution":
            attrs = [P.attr_ints("kernel_shape", kw["kernel"]),
                     P.attr_ints("strides", kw.get("stride", (1, 1))),
                     P.attr_ints("pads", tuple(kw.get("pad", (0, 0))) * 2),
                     P.attr_ints("dilations", kw.get("dilate", (1, 1))),
                     P.attr_int("group", kw.get("num_group", 1))]
            cin = ins[:2] + (ins[2:3] if not kw.get("no_bias") else [])
            nodes.append(P.node("Conv", cin, [out], out, attrs))
        elif op == "BatchNorm":
            attrs = [P.attr_float("epsilon", kw.get("eps", 1e-5)),
                     P.attr_float("momentum", kw.get("momentum", 0.9))]
            # mx order: data,gamma,beta,mean,var == onnx: X,scale,B,mean,var.
            # fix_gamma=True (mx default) means gamma is IGNORED in compute —
            # ONNX has no such flag, so emit a ones scale to match the math
            if kw.get("fix_gamma", True):
                ones_name = fresh("bn_scale_ones")
                extra_inits[ones_name] = None  # filled after shapes known
                fix_gamma_ones.append((ones_name, ins[1]))
                ins = [ins[0], ones_name] + ins[2:]
            nodes.append(P.node("BatchNormalization", ins[:5], [out], out,
                                attrs))
        elif op == "Activation":
            nodes.append(P.node(_ACT[kw.get("act_type", "relu")], ins, [out],
                                out))
        elif op == "Pooling":
            ptype = kw.get("pool_type", "max")
            if kw.get("global_pool"):
                o = "GlobalMaxPool" if ptype == "max" else "GlobalAveragePool"
                nodes.append(P.node(o, ins, [out], out))
            else:
                o = "MaxPool" if ptype == "max" else "AveragePool"
                k = tuple(kw["kernel"])
                attrs = [P.attr_ints("kernel_shape", k),
                         P.attr_ints("strides", kw.get("stride") or (1,) * len(k)),
                         P.attr_ints("pads",
                                     tuple(kw.get("pad") or (0,) * len(k)) * 2)]
                if o == "AveragePool":
                    attrs.append(P.attr_int("count_include_pad", 1))
                nodes.append(P.node(o, ins, [out], out, attrs))
        elif op in ("softmax", "SoftmaxOutput", "log_softmax"):
            nodes.append(P.node("Softmax", ins[:1], [out], out,
                                [P.attr_int("axis", kw.get("axis", -1))]))
            if op == "log_softmax":
                lg = fresh("log")
                nodes.append(P.node("Log", [out], [lg], lg))
                name_of[id(base)] = lg
                return lg
        elif op == "concat":
            nodes.append(P.node("Concat", ins, [out], out,
                                [P.attr_int("axis", kw.get("dim",
                                                           kw.get("axis", 1)))]))
        elif op == "Dropout":
            nodes.append(P.node("Dropout", ins[:1], [out], out))
        elif op == "dot":
            nodes.append(P.node("MatMul", ins, [out], out))
        elif op == "reshape":
            shp = onp.asarray(kw.get("shape"), "int64")
            sname = fresh("shape")
            extra_inits[sname] = shp
            nodes.append(P.node("Reshape", [ins[0], sname], [out], out))
        elif op == "transpose":
            axes = kw.get("axes")
            attrs = [P.attr_ints("perm", axes)] if axes else []
            nodes.append(P.node("Transpose", ins, [out], out, attrs))
        elif op == "clip":
            lo = onp.asarray(kw.get("a_min"), "float32")
            hi = onp.asarray(kw.get("a_max"), "float32")
            ln, hn = fresh("clip_min"), fresh("clip_max")
            extra_inits[ln] = lo
            extra_inits[hn] = hi
            nodes.append(P.node("Clip", [ins[0], ln, hn], [out], out))
        elif op == "Embedding":
            # mx input order (indices, weight) -> Gather(weight, indices);
            # indices cast to int64 (the sym-level dtype is unconstrained)
            idx = fresh("emb_idx")
            nodes.append(P.node("Cast", [ins[0]], [idx], idx,
                                [P.attr_int("to", P.DT_INT64)]))
            nodes.append(P.node("Gather", [ins[1], idx], [out], out,
                                [P.attr_int("axis", 0)]))
        elif op == "LayerNorm":
            nodes.append(P.node("LayerNormalization", ins[:3], [out], out,
                                [P.attr_int("axis", kw.get("axis", -1)),
                                 P.attr_float("epsilon",
                                              kw.get("eps", 1e-5))]))
        elif op == "batch_dot":
            a, b = ins
            # the reference's batch_dot op contract is rank-3 (one batch
            # axis — src/operator/tensor/dot-inl.h), so the transpose
            # fix-up perm is the rank-3 (0, 2, 1)
            if kw.get("transpose_a"):
                t = fresh("bdot_ta")
                nodes.append(P.node("Transpose", [a], [t], t,
                                    [P.attr_ints("perm", (0, 2, 1))]))
                a = t
            if kw.get("transpose_b"):
                t = fresh("bdot_tb")
                nodes.append(P.node("Transpose", [b], [t], t,
                                    [P.attr_ints("perm", (0, 2, 1))]))
                b = t
            nodes.append(P.node("MatMul", [a, b], [out], out))
        elif op == "LeakyReLU":
            at = kw.get("act_type", "leaky")
            if at == "leaky":
                nodes.append(P.node("LeakyRelu", ins[:1], [out], out,
                                    [P.attr_float("alpha",
                                                  kw.get("slope", 0.25))]))
            elif at == "elu":
                nodes.append(P.node("Elu", ins[:1], [out], out,
                                    [P.attr_float("alpha",
                                                  kw.get("slope", 0.25))]))
            elif at == "selu":
                nodes.append(P.node("Selu", ins[:1], [out], out))
            elif at == "prelu":
                nodes.append(P.node("PRelu", ins[:2], [out], out))
            elif at == "gelu":
                # exact gelu = 0.5 * x * (1 + erf(x / sqrt(2))): Erf exists
                # at opset 13, Gelu only at 20
                s = fresh("gelu_s")
                extra_inits[s] = onp.asarray(1.0 / onp.sqrt(2.0), "float32")
                h = fresh("gelu_h")
                extra_inits[h] = onp.asarray(0.5, "float32")
                one = fresh("gelu_1")
                extra_inits[one] = onp.asarray(1.0, "float32")
                d, e, a1, m1 = (fresh("gelu_div"), fresh("gelu_erf"),
                                fresh("gelu_add"), fresh("gelu_mul"))
                nodes.append(P.node("Mul", [ins[0], s], [d], d))
                nodes.append(P.node("Erf", [d], [e], e))
                nodes.append(P.node("Add", [e, one], [a1], a1))
                nodes.append(P.node("Mul", [ins[0], a1], [m1], m1))
                nodes.append(P.node("Mul", [m1, h], [out], out))
            else:
                raise NotImplementedError(
                    "ONNX export: LeakyReLU act_type %r" % at)
        elif op == "where":
            # ONNX Where requires a bool condition; mx conditions are
            # arithmetic 0/1 masks
            cond = fresh("where_cond")
            nodes.append(P.node("Cast", [ins[0]], [cond], cond,
                                [P.attr_int("to", P.DT_BOOL)]))
            nodes.append(P.node("Where", [cond, ins[1], ins[2]], [out], out))
        elif op in _CMP_SCALAR or op in _CMP:
            if op in _CMP:
                o, pair = _CMP[op], ins
            else:
                o = _CMP_SCALAR[op]
                if o is None:
                    raise NotImplementedError("ONNX export: %s" % op)
                sc = fresh("cmp_scalar")
                extra_inits[sc] = onp.asarray(kw["scalar"], "float32")
                pair = [sc, ins[0]] if kw.get("reverse") else [ins[0], sc]
            cb = fresh("cmp_bool")
            nodes.append(P.node(o, pair, [cb], cb))
            nodes.append(P.node("Cast", [cb], [out], out,
                                [P.attr_int("to", P.DT_FLOAT)]))
        elif op == "square":
            nodes.append(P.node("Mul", [ins[0], ins[0]], [out], out))
        elif op == "expand_dims":
            ax = fresh("unsq_axes")
            extra_inits[ax] = onp.asarray([kw["axis"]], "int64")
            nodes.append(P.node("Unsqueeze", [ins[0], ax], [out], out))
        elif op == "squeeze":
            axis = kw.get("axis")
            sq_in = [ins[0]]
            if axis is not None:
                ax = fresh("sq_axes")
                axes = axis if isinstance(axis, (tuple, list)) else (axis,)
                extra_inits[ax] = onp.asarray(axes, "int64")
                sq_in.append(ax)
            nodes.append(P.node("Squeeze", sq_in, [out], out))
        elif op in ("slice_axis", "slice"):
            if op == "slice_axis":
                axes = (kw["axis"],)
                begin = (kw.get("begin") or 0,)
                end = (kw.get("end"),)
                step = (1,)
            else:
                begin = tuple(kw.get("begin") or ())
                end = tuple(kw.get("end") or ())
                step = tuple(kw.get("step") or (1,) * len(begin))
                axes = tuple(range(len(begin)))
            INT_MAX = 2 ** 62
            sp = onp.asarray([s if s is not None else 1 for s in step],
                             "int64")
            if any(s == 0 for s in sp):
                raise ValueError("ONNX export: slice step 0")
            # open (None) bounds follow the step's direction: a negative
            # step starts from the far end (runtimes clamp INT_MAX to
            # dim-1) and runs to before the beginning (-INT_MAX) — the
            # former unconditional +INT_MAX end made conformant runtimes
            # (onnxruntime) evaluate reversed slices as empty
            st = onp.asarray([b if b is not None
                              else (0 if s > 0 else INT_MAX)
                              for b, s in zip(begin, sp)], "int64")
            en = onp.asarray([e if e is not None
                              else (INT_MAX if s > 0 else -INT_MAX)
                              for e, s in zip(end, sp)], "int64")
            sn, enn, axn, spn = (fresh("sl_st"), fresh("sl_en"),
                                 fresh("sl_ax"), fresh("sl_sp"))
            extra_inits[sn] = st
            extra_inits[enn] = en
            extra_inits[axn] = onp.asarray(axes, "int64")
            extra_inits[spn] = sp
            nodes.append(P.node("Slice", [ins[0], sn, enn, axn, spn],
                                [out], out))
        elif op in ("cast", "Cast"):
            nodes.append(P.node(
                "Cast", ins, [out], out,
                [P.attr_int("to", P._NP2ONNX[str(onp.dtype(kw["dtype"]))])]))
        elif op in _SCALAR:
            sc = fresh("scalar")
            extra_inits[sc] = onp.asarray(kw["scalar"], "float32")
            pair = [sc, ins[0]] if kw.get("reverse") else [ins[0], sc]
            nodes.append(P.node(_SCALAR[op], pair, [out], out))
        elif op == "RNN":
            # pops the flat parameter vector from params (it is re-emitted
            # as per-layer W/R/B initializers)
            _export_rnn(base, ins, kw, params, nodes, extra_inits,
                        fresh, out)
        elif op in _ELEM:
            nodes.append(P.node(_ELEM[op], ins, [out], out))
        elif op in _UNARY:
            attrs = [P.attr_int("axis", 1)] if _UNARY[op] == "Flatten" else []
            nodes.append(P.node(_UNARY[op], ins, [out], out, attrs))
        else:
            raise NotImplementedError(
                "ONNX export: unsupported op %r (supported: see module "
                "docstring)" % op)
        name_of[id(base)] = out
        return out

    out_name = emit(sym)

    for ones_name, gamma_name in fix_gamma_ones:
        shp = params[gamma_name].shape if gamma_name in params else (1,)
        extra_inits[ones_name] = onp.ones(shp, "float32")
    for k, v in params.items():
        arr = v.asnumpy() if isinstance(v, NDArray) else onp.asarray(v)
        initializers.append(P.tensor(k, arr))
    for k, v in extra_inits.items():
        initializers.append(P.tensor(k, v))

    inputs = [P.value_info(n, s, input_type)
              for n, s in zip(data_names, input_shape)]
    # ONNX requires initializers to also appear as graph inputs pre-IR4 —
    # modern runtimes don't; we list only real data inputs (IR 8)
    all_shapes = {n: s for n, s in zip(data_names, input_shape)}
    all_shapes.update(shape_hints)
    try:
        _, out_shapes, _ = sym.infer_shape(**all_shapes)
    except Exception:
        out_shapes = None
    outputs = [P.value_info(out_name, out_shapes[0] if out_shapes else (),
                            "float32")]
    g = P.graph("mxtpu_graph", nodes, inputs, outputs, initializers)
    buf = P.model(g, opset=17)   # 17: LayerNormalization
    with open(onnx_file_path, "wb") as f:
        f.write(buf)
    return onnx_file_path


def get_model_metadata(model_file):
    """ref onnx2mx get_model_metadata."""
    with open(model_file, "rb") as f:
        m = P.read_model(f.read())
    g = m["graph"]
    return {"input_tensor_data": P.read_value_infos(g, 11),
            "output_tensor_data": P.read_value_infos(g, 12)}


def import_model(model_file):
    """.onnx file → (sym, arg_params, aux_params) (MXNet's
    onnx2mx/import_model); the parameters are host NDArrays, as MXNet's
    are (``Module.bind``/``set_params`` copies them onto its context).
    Each initializer's variable carries its shape and BatchNorm's moving
    statistics are auxiliary states, so ``Module`` binds the graph from the
    data's shape alone (the JAX package's import does not infer them)."""
    from .. import symbol as mxsym
    from .. import ndarray as nd
    from ..context import cpu

    with open(model_file, "rb") as f:
        m = P.read_model(f.read())
    g = m["graph"]
    inits = P.read_initializers(g)
    value = {}  # onnx value name -> Symbol
    for name, _shape, _dt in P.read_value_infos(g, 11):
        value[name] = mxsym.var(name)

    arg_params, aux_params = {}, {}
    for k, v in inits.items():
        arg_params[k] = nd.array(onp.asarray(v), ctx=cpu())

    def sym_of(name):
        if name in value:
            return value[name]
        if name in inits:
            # the variable carries its initializer's shape (as the layer
            # ops' own parameter variables carry theirs), so the graph
            # binds through Module and simple_bind from the data's shape
            v = mxsym.var(name)
            v._deferred_shape_fn = lambda _s, n=name: tuple(
                (arg_params[n] if n in arg_params else aux_params[n]).shape)
            v._is_param = True
            value[name] = v
            return v
        raise ValueError("ONNX import: undefined input %r" % name)

    last = None
    for n in P.read_nodes(g):
        op, at = n["op_type"], n["attrs"]
        if op in ("LSTM", "GRU", "RNN"):
            # "" marks an omitted optional input (sequence_lens, B, h0, c0)
            ins = [sym_of(i) if i else None for i in n["inputs"]]
        else:
            ins = [sym_of(i) for i in n["inputs"]]
        if op == "Gemm":
            if at.get("alpha", 1.0) != 1.0 or at.get("beta", 1.0) != 1.0 \
                    or at.get("transA", 0):
                raise NotImplementedError(
                    "ONNX import: Gemm with alpha/beta != 1 or transA")
            wname = n["inputs"][1]
            if wname not in arg_params:
                raise NotImplementedError(
                    "ONNX import: Gemm weight must be an initializer")
            if not at.get("transB", 0):
                # (in, out) layout → FullyConnected's (out, in)
                arg_params[wname] = nd.array(arg_params[wname].asnumpy().T,
                                             ctx=cpu())
            out = mxsym.FullyConnected(
                data=ins[0], weight=ins[1],
                bias=ins[2] if len(ins) > 2 else None,
                num_hidden=int(arg_params[wname].shape[0]),
                no_bias=len(ins) < 3, flatten=False, name=n["outputs"][0])
        elif op == "Conv":
            w = arg_params[n["inputs"][1]]
            out = mxsym.Convolution(
                data=ins[0], weight=ins[1],
                bias=ins[2] if len(ins) > 2 else None,
                kernel=tuple(at["kernel_shape"]),
                stride=tuple(at.get("strides", (1, 1))),
                pad=_sym_pads(at, len(at["kernel_shape"])),
                dilate=tuple(at.get("dilations", (1, 1))),
                num_filter=int(w.shape[0]),
                num_group=int(at.get("group", 1)),
                no_bias=len(ins) < 3, name=n["outputs"][0])
        elif op == "BatchNormalization":
            # fix_gamma=False: ONNX scale is ALWAYS applied (our export emits
            # explicit ones when the source had fix_gamma=True)
            out = mxsym.BatchNorm(
                data=ins[0], gamma=ins[1], beta=ins[2], moving_mean=ins[3],
                moving_var=ins[4], eps=float(at.get("epsilon", 1e-5)),
                momentum=float(at.get("momentum", 0.9)), fix_gamma=False,
                use_global_stats=True, name=n["outputs"][0])
            for mi, which in ((3, aux_params), (4, aux_params)):
                nm = n["inputs"][mi]
                if nm in arg_params:
                    which[nm] = arg_params.pop(nm)
                ins[mi]._is_aux = True
        elif op == "Softplus":
            out = mxsym.Activation(ins[0], act_type="softrelu")
        elif op in ("Relu", "Sigmoid", "Tanh", "Exp", "Log",
                    "Sqrt", "Neg", "Abs", "Identity"):
            fn = {"Relu": mxsym.relu, "Sigmoid": mxsym.sigmoid,
                  "Tanh": mxsym.tanh, "Exp": mxsym.exp, "Log": mxsym.log,
                  "Sqrt": mxsym.sqrt, "Neg": mxsym.negative,
                  "Abs": mxsym.abs, "Identity": mxsym.identity}[op]
            out = fn(ins[0])
        elif op in ("MaxPool", "AveragePool"):
            out = mxsym.Pooling(
                data=ins[0], kernel=tuple(at["kernel_shape"]),
                stride=tuple(at.get("strides", (1, 1))),
                pad=_sym_pads(at, len(at["kernel_shape"])),
                pool_type="max" if op == "MaxPool" else "avg",
                name=n["outputs"][0])
        elif op in ("GlobalMaxPool", "GlobalAveragePool"):
            out = mxsym.Pooling(
                data=ins[0], global_pool=True,
                pool_type="max" if op == "GlobalMaxPool" else "avg",
                kernel=(1, 1), name=n["outputs"][0])
        elif op == "Flatten":
            out = mxsym.flatten(ins[0])
        elif op == "Softmax":
            out = mxsym.softmax(ins[0], axis=int(at.get("axis", -1)))
        elif op == "Dropout":
            out = mxsym.identity(ins[0])
        elif op == "Concat":
            out = mxsym.concat(*ins, dim=int(at.get("axis", 1)))
        elif op == "MatMul":
            # ONNX MatMul is numpy-matmul (batched on leading dims) —
            # linalg_gemm2, not the 2-D-only dot
            out = mxsym.linalg_gemm2(ins[0], ins[1])
        elif op == "Reshape":
            shp = tuple(int(x) for x in
                        onp.asarray(inits[n["inputs"][1]]).tolist())
            arg_params.pop(n["inputs"][1], None)
            out = mxsym.reshape(ins[0], shape=shp)
        elif op == "Transpose":
            out = mxsym.transpose(ins[0], axes=tuple(at["perm"])
                                  if "perm" in at else None)
        elif op == "Clip":
            lo = float(onp.asarray(inits[n["inputs"][1]]))
            hi = float(onp.asarray(inits[n["inputs"][2]]))
            arg_params.pop(n["inputs"][1], None)
            arg_params.pop(n["inputs"][2], None)
            out = mxsym.clip(ins[0], a_min=lo, a_max=hi)
        elif op in ("Add", "Sub", "Mul", "Div"):
            fn = {"Add": mxsym.broadcast_add, "Sub": mxsym.broadcast_sub,
                  "Mul": mxsym.broadcast_mul, "Div": mxsym.broadcast_div}[op]
            out = fn(ins[0], ins[1])
        elif op == "Pow":
            out = mxsym.broadcast_power(ins[0], ins[1])
        elif op in ("Max", "Min"):
            fn = (mxsym.broadcast_maximum if op == "Max"
                  else mxsym.broadcast_minimum)
            out = ins[0]
            for other in ins[1:]:
                out = fn(out, other)
        elif op in ("Greater", "Less", "GreaterOrEqual", "LessOrEqual",
                    "Equal"):
            fn = {"Greater": mxsym.broadcast_greater,
                  "Less": mxsym.broadcast_lesser,
                  "GreaterOrEqual": mxsym.broadcast_greater_equal,
                  "LessOrEqual": mxsym.broadcast_lesser_equal,
                  "Equal": mxsym.broadcast_equal}[op]
            out = fn(ins[0], ins[1])
        elif op == "Erf":
            out = mxsym.erf(ins[0])
        elif op == "Where":
            out = mxsym.where(ins[0], ins[1], ins[2])
        elif op == "Gather":
            out = mxsym.take(ins[0], ins[1], axis=int(at.get("axis", 0)))
        elif op == "Cast":
            out = mxsym.cast(ins[0], dtype=P._ONNX2NP[int(at["to"])])
        elif op == "LayerNormalization":
            out = mxsym.LayerNorm(ins[0], ins[1], ins[2],
                                  axis=int(at.get("axis", -1)),
                                  eps=float(at.get("epsilon", 1e-5)))
        elif op == "LeakyRelu":
            out = mxsym.LeakyReLU(ins[0], act_type="leaky",
                                  slope=float(at.get("alpha", 0.01)))
        elif op == "Elu":
            out = mxsym.LeakyReLU(ins[0], act_type="elu",
                                  slope=float(at.get("alpha", 1.0)))
        elif op == "Selu":
            out = mxsym.LeakyReLU(ins[0], act_type="selu")
        elif op == "PRelu":
            out = mxsym.LeakyReLU(ins[0], gamma=ins[1], act_type="prelu")
        elif op == "Unsqueeze":
            axes = [int(a) for a in onp.asarray(inits[n["inputs"][1]])]
            arg_params.pop(n["inputs"][1], None)
            # axes reference positions in the OUTPUT rank: non-negative
            # axes apply ascending, all-negative apply descending (each
            # expand_dims(-k) then lands at its final position); a mix
            # cannot be resolved without the input rank
            if all(a >= 0 for a in axes):
                order = sorted(axes)
            elif all(a < 0 for a in axes):
                order = sorted(axes, reverse=True)
            else:
                raise NotImplementedError(
                    "ONNX import: Unsqueeze with mixed-sign axes %r" % axes)
            out = ins[0]
            for a in order:
                out = mxsym.expand_dims(out, axis=a)
        elif op == "Squeeze":
            if len(n["inputs"]) > 1 and n["inputs"][1]:
                axes = tuple(int(a)
                             for a in onp.asarray(inits[n["inputs"][1]]))
                arg_params.pop(n["inputs"][1], None)
                out = mxsym.squeeze(ins[0], axis=axes if len(axes) > 1
                                    else axes[0])
            else:
                out = mxsym.squeeze(ins[0])
        elif op == "Slice":
            names = n["inputs"]
            starts = [int(v) for v in onp.asarray(inits[names[1]])]
            ends = [int(v) for v in onp.asarray(inits[names[2]])]
            axes = ([int(v) for v in onp.asarray(inits[names[3]])]
                    if len(names) > 3 and names[3]
                    else list(range(len(starts))))
            steps = ([int(v) for v in onp.asarray(inits[names[4]])]
                     if len(names) > 4 and names[4] else [1] * len(starts))
            if any(s < 1 for s in steps):
                raise NotImplementedError("ONNX import: Slice steps < 1")
            for nm in names[1:]:
                arg_params.pop(nm, None)
            INT_MAX = 2 ** 62
            if all(s == 1 for s in steps):
                out = ins[0]
                for ax, b, e in zip(axes, starts, ends):
                    out = mxsym.slice_axis(out, axis=ax, begin=b,
                                           end=None if e >= INT_MAX else e)
            else:
                # strided slice: mx.sym.slice takes per-leading-axis
                # begin/end/step tuples, so axes must be non-negative —
                # a raw -1 would compute rank 0 and mis-index; the input
                # rank is not known symbolically here, so reject loudly
                # (the unit-step slice_axis path above tolerates them)
                if any(a < 0 for a in axes):
                    raise NotImplementedError(
                        "ONNX import: strided Slice with negative axes %r "
                        "(input rank unknown at import)" % (axes,))
                rank = max(axes) + 1
                bg, en_, sp = ([0] * rank, [None] * rank, [1] * rank)
                for ax, b, e, s in zip(axes, starts, ends, steps):
                    bg[ax] = b
                    en_[ax] = None if e >= INT_MAX else e
                    sp[ax] = s
                out = mxsym.slice(ins[0], begin=tuple(bg), end=tuple(en_),
                                  step=tuple(sp))
        elif op in ("LSTM", "GRU", "RNN"):
            out = _import_rnn(n, at, ins, inits, arg_params, value,
                              mxsym, nd, op)
            # only Y maps; binding Y_h/Y_c to the same tensor would
            # silently hand consumers the full sequence — leave them
            # unbound so sym_of fails loudly instead
            value[n["outputs"][0]] = out
            last = out
            continue
        else:
            raise NotImplementedError("ONNX import: unsupported op %r" % op)
        for o in n["outputs"]:
            value[o] = out
        last = out
    # the graph's DECLARED outputs win over file order (field 12)
    declared = [name for name, _s, _d in P.read_value_infos(g, 12)]
    if declared:
        if declared[0] not in value:
            # e.g. an RNN Y_h/Y_c consumer: falling back to the last node
            # would silently return the wrong tensor
            raise ValueError("ONNX import: undefined input %r (declared "
                             "graph output was never produced)"
                             % declared[0])
        last = value[declared[0]]
    return last, arg_params, aux_params


def _import_rnn(n, at, ins, inits, arg_params, value, mxsym, nd, op):
    """ONNX LSTM/GRU/RNN node -> sym.RNN: per-direction W/R/B initializers
    repacked (ONNX gate order -> our cuDNN layout) into the flat parameter
    vector; an omitted initial state maps to nd.RNN's state=None zeros."""
    H = int(at["hidden_size"])
    bidir = at.get("direction", "forward") == "bidirectional"
    D = 2 if bidir else 1
    if at.get("clip") or at.get("layout"):
        raise NotImplementedError("ONNX import: RNN clip/layout attrs")
    acts = at.get("activations")
    mode = {"LSTM": "lstm", "GRU": "gru"}.get(op)
    if mode is None:
        # vanilla RNN: one activation per direction, all equal
        acts = acts or ["Tanh"] * D
        if len(set(acts)) != 1 or acts[0] not in ("Relu", "Tanh"):
            raise NotImplementedError(
                "ONNX import: RNN activations %r (need uniform Relu or "
                "Tanh)" % (acts,))
        mode = "rnn_relu" if acts[0] == "Relu" else "rnn_tanh"
    elif acts is not None:
        # sym.RNN's recurrence is the cuDNN fixed set — anything else
        # would silently change numerics
        default = (["Sigmoid", "Tanh", "Tanh"] if op == "LSTM"
                   else ["Sigmoid", "Tanh"]) * D
        if list(acts) != default:
            raise NotImplementedError(
                "ONNX import: non-default %s activations %r" % (op, acts))
    G = {"lstm": 4, "gru": 3}.get(mode, 1)
    names = n["inputs"]
    if len(names) > 4 and names[4]:
        raise NotImplementedError("ONNX import: RNN sequence_lens")
    if op == "GRU" and not int(at.get("linear_before_reset", 0)):
        raise NotImplementedError(
            "ONNX import: GRU linear_before_reset=0 (cuDNN layout is 1)")
    # read_initializers yields plain numpy arrays — one uniform conversion
    # for W, R, and B (no wrapper special-cases)
    W = onp.asarray(inits[names[1]], "float32")
    R = onp.asarray(inits[names[2]], "float32")
    B = (onp.asarray(inits[names[3]], "float32")
         if len(names) > 3 and names[3]
         else onp.zeros((D, 2 * G * H), "float32"))
    for nm in names[1:4]:
        if nm:
            arg_params.pop(nm, None)
    wi = [_gate_reorder(W[d], mode, inverse=True) for d in range(D)]
    wh = [_gate_reorder(R[d], mode, inverse=True) for d in range(D)]
    bi = [_gate_reorder(B[d][:G * H], mode, inverse=True) for d in range(D)]
    bh = [_gate_reorder(B[d][G * H:], mode, inverse=True) for d in range(D)]
    flat = onp.concatenate(
        [x.ravel() for pair in zip(wi, wh) for x in pair]
        + [x.ravel() for pair in zip(bi, bh) for x in pair])
    pname = (n["name"] or n["outputs"][0]) + "_parameters"
    from ..context import cpu
    arg_params[pname] = nd.array(flat, ctx=cpu())
    value[pname] = mxsym.var(pname)
    h0 = ins[5] if len(ins) > 5 else None
    c0 = ins[6] if mode == "lstm" and len(ins) > 6 else None
    rnn_out = mxsym.RNN(ins[0], value[pname], h0, c0, state_size=H,
                        num_layers=1, mode=mode, bidirectional=bidir)
    # our (T, N, D*H) -> ONNX Y layout (T, D, N, H); only Y is mapped —
    # a graph consuming Y_h/Y_c fails loudly at sym_of
    return mxsym.transpose(mxsym.reshape(rnn_out, shape=(0, 0, D, -1)),
                           axes=(0, 2, 1, 3))


def _gate_reorder(a, mode, inverse=False):
    """Permute the G gate blocks along axis 0 of a (G*H, ...) weight/bias
    between our cuDNN layout and ONNX's (see _GATE_PERM)."""
    perm = (_GATE_UNPERM if inverse else _GATE_PERM)[mode]
    parts = onp.split(a, len(perm), axis=0)
    return onp.concatenate([parts[p] for p in perm], axis=0)


def _export_rnn(base, ins, kw, params, nodes, extra_inits, fresh, out):
    """Monolithic RNN op -> a stack of ONNX LSTM/GRU/RNN nodes (one per
    layer), unpacking the flat cuDNN-layout parameter vector
    (ndarray/rnn_op.py _dims) into per-layer W/R/B initializers with the
    gate blocks repacked to ONNX order."""
    from ..ndarray import NDArray
    from ..ndarray.rnn_op import _dims

    mode = kw.get("mode", "lstm")
    H = int(kw["state_size"])
    L = int(kw.get("num_layers", 1))
    bidir = bool(kw.get("bidirectional", False))
    D = 2 if bidir else 1
    if kw.get("state_outputs"):
        raise NotImplementedError("ONNX export: RNN state_outputs=True")
    # resolve the POSITIONAL slots (data, parameters, state, state_cell):
    # an omitted optional input is an "N" entry in __arg_spec__ with NO
    # corresponding element in ins/_inputs, so raw positions shift —
    # e.g. RNN(data, p, None, c0) has c0 at ins[2], not ins[3]
    spec = kw.get("__arg_spec__")
    slot_names, slot_syms = [], []
    ii = 0
    for s in (spec or (None,) * len(ins)):
        if s == "N":
            slot_names.append(None)
            slot_syms.append(None)
        elif s is None:
            slot_names.append(ins[ii])
            slot_syms.append(base._inputs[ii])
            ii += 1
        else:
            raise NotImplementedError("ONNX export: RNN list inputs")
    psym = slot_syms[1] if len(slot_syms) > 1 else None
    pbase = psym and (getattr(psym, "_base", None) or psym)
    if not (pbase is not None and pbase.is_var and pbase.name in params):
        raise NotImplementedError(
            "ONNX export: the RNN parameter vector must be an initializer")
    flat = params.pop(pbase.name)
    flat = flat.asnumpy() if isinstance(flat, NDArray) else onp.asarray(flat)
    G = {"lstm": 4, "gru": 3}.get(mode, 1)
    # input size from the flat length: total = D*G*H*(I+H) [layer 0]
    #   + (L-1)*D*G*H*(D*H+H) [stacked layers] + L*D*2*G*H [biases]
    rest = flat.size - L * D * 2 * G * H - (L - 1) * D * G * H * (D * H + H)
    I = rest // (D * G * H) - H
    blocks, off = {}, 0
    for kind, layer, d, shp in _dims(mode, int(I), H, L, bidir):
        n_el = int(onp.prod(shp))
        blocks[(kind, layer, d)] = flat[off:off + n_el].reshape(shp)
        off += n_el
    if off != flat.size:
        raise ValueError("RNN parameter vector length mismatch")

    x_name = slot_names[0]
    state_name = (slot_names[2] or "") if len(slot_names) > 2 else ""
    cell_name = (slot_names[3] or "") if len(slot_names) > 3 else ""

    def state_slice(src, layer, tag):
        if L == 1:
            return src   # the whole state IS this layer's (D, N, H)
        o = fresh("rnn_%s" % tag)
        sn, en, an = fresh("rnn_st"), fresh("rnn_en"), fresh("rnn_ax")
        extra_inits[sn] = onp.asarray([layer * D], "int64")
        extra_inits[en] = onp.asarray([(layer + 1) * D], "int64")
        extra_inits[an] = onp.asarray([0], "int64")
        nodes.append(P.node("Slice", [src, sn, en, an], [o], o))
        return o

    for layer in range(L):
        W = onp.stack([_gate_reorder(blocks[("wi", layer, d)], mode)
                       for d in range(D)]).astype("float32")
        R = onp.stack([_gate_reorder(blocks[("wh", layer, d)], mode)
                       for d in range(D)]).astype("float32")
        B = onp.stack([onp.concatenate(
            [_gate_reorder(blocks[("bi", layer, d)], mode),
             _gate_reorder(blocks[("bh", layer, d)], mode)])
            for d in range(D)]).astype("float32")
        wn, rn, bn = fresh("rnn_W"), fresh("rnn_R"), fresh("rnn_B")
        extra_inits[wn] = W
        extra_inits[rn] = R
        extra_inits[bn] = B
        node_in = [x_name, wn, rn, bn, ""]   # sequence_lens: absent
        node_in.append(state_slice(state_name, layer, "h0")
                       if state_name else "")
        if mode == "lstm":
            node_in.append(state_slice(cell_name, layer, "c0")
                           if cell_name else "")
        attrs = [P.attr_int("hidden_size", H),
                 P.attr_string("direction",
                               "bidirectional" if bidir else "forward")]
        if mode == "gru":
            # our recurrence applies the reset gate AFTER h's linear map
            # (incl. bias) — exactly ONNX linear_before_reset=1
            attrs.append(P.attr_int("linear_before_reset", 1))
        if mode in ("rnn_relu", "rnn_tanh"):
            act = "Relu" if mode == "rnn_relu" else "Tanh"
            attrs.append(P.attr_strings("activations", [act] * D))
        y = fresh("rnn_Y")
        outs = [y, fresh("rnn_Yh")] + ([fresh("rnn_Yc")]
                                       if mode == "lstm" else [])
        nodes.append(P.node(_ONNX_RNN_OP[mode], node_in, outs, y, attrs))
        # ONNX Y (T, D, N, H) -> our layout (T, N, D*H)
        tr = fresh("rnn_tr")
        nodes.append(P.node("Transpose", [y], [tr], tr,
                            [P.attr_ints("perm", (0, 2, 1, 3))]))
        shp = fresh("rnn_shp")
        extra_inits[shp] = onp.asarray([0, 0, -1], "int64")
        dst = out if layer == L - 1 else fresh("rnn_X")
        nodes.append(P.node("Reshape", [tr, shp], [dst], dst))
        x_name = dst


def _sym_pads(at, ndim):
    """ONNX pads are [begin..., end...]; mx supports symmetric only."""
    pads = tuple(at.get("pads", (0,) * 2 * ndim))
    begin, end = pads[:ndim], pads[ndim:2 * ndim]
    if end and begin != end:
        raise NotImplementedError(
            "ONNX import: asymmetric padding %s unsupported" % (pads,))
    if at.get("auto_pad", "") not in ("", "NOTSET"):
        raise NotImplementedError("ONNX import: auto_pad unsupported")
    return begin
