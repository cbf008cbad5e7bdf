"""Helper module of the extended C API tier
(``native/src/c_predict_api.cc`` MXTPUKVStore*, MXTPUProfiler*,
MXTPUNDArraySave/Load, MXTPUSymbolInferShape, ...; counterpart of
``incubator_mxnet_tpu/native/_ext_embed.py``; ref include/mxnet/c_api.h
MXKVStore*, MXProfile*, MXNDArraySave/Load, MXSymbolInferShape,
MXListAllOpNames, MXRandomSeed and MXLoadLib).

The layering of the graph and invoke tiers: the C side marshals plain
types and opaque handles, these helpers do the Python-object work against
the port's own frontend (``kv``, ``nd.save``/``load``, ``sym``,
``profiler``, ``library``), each call under ``capi_context()``.
"""
from __future__ import annotations

import json

from . import in_capi_context

__all__ = [
    "nd_save", "nd_load_bundle", "bundle_len", "bundle_name", "bundle_item",
    "sym_from_json", "sym_save_file", "sym_list_aux", "sym_infer_shape",
    "sym_get_attr", "sym_set_attr",
    "kv_create", "kv_type", "kv_rank", "kv_num_workers", "kv_init",
    "kv_push", "kv_pull", "kv_pushpull", "kv_broadcast", "kv_set_compression",
    "profiler_set_config", "profiler_set_state", "profiler_dump",
    "profiler_summary",
    "random_seed", "list_all_op_names", "load_lib", "wait_all",
]


def _mx():
    import incubator_mxnet_tpu_torch as mx
    return mx


# ------------------------------------------------------- NDArray save/load
@in_capi_context
def nd_save(fname, names, arrays):
    """≙ MXNDArraySave: all names empty saves a positional list; named
    saves are all-or-none (mixed or duplicate names would silently drop
    arrays through the dict, so they are rejected)."""
    mx = _mx()
    if names and any(names):
        if not all(names):
            raise ValueError("nd_save: mixed empty/non-empty names")
        if len(set(names)) != len(names):
            raise ValueError("nd_save: duplicate names %s"
                             % sorted(n for n in set(names)
                                      if names.count(n) > 1))
        mx.nd.save(fname, dict(zip(names, arrays)))
    else:
        mx.nd.save(fname, list(arrays))


@in_capi_context
def nd_load_bundle(fname):
    """≙ MXNDArrayLoad: returns a (names, arrays) bundle object."""
    out = _mx().nd.load(fname)
    if isinstance(out, dict):
        keys = list(out)
        return (keys, [out[k] for k in keys])
    return ([""] * len(out), list(out))


@in_capi_context
def bundle_len(bundle):
    return len(bundle[1])


@in_capi_context
def bundle_name(bundle, i):
    return bundle[0][i]


@in_capi_context
def bundle_item(bundle, i):
    return bundle[1][i]


# ----------------------------------------------------------------- Symbol
@in_capi_context
def sym_from_json(js):
    return _mx().sym.load_json(js)


@in_capi_context
def sym_save_file(s, fname):
    s.save(fname)


@in_capi_context
def sym_list_aux(s):
    return json.dumps(list(s.list_auxiliary_states()))


@in_capi_context
def sym_infer_shape(s, shapes_json):
    """≙ MXSymbolInferShape: known input shapes in, (arg, out, aux) shape
    table out (JSON)."""
    shapes = {k: tuple(int(d) for d in v)
              for k, v in json.loads(shapes_json).items()}
    arg_shapes, out_shapes, aux_shapes = s.infer_shape(**shapes)
    if arg_shapes is None:
        raise ValueError("infer_shape needs every input shape (got %s)"
                         % sorted(shapes))
    return json.dumps({"arg_shapes": [list(x) for x in arg_shapes],
                       "out_shapes": [list(x) for x in out_shapes],
                       "aux_shapes": [list(x) for x in (aux_shapes or [])]})


@in_capi_context
def sym_get_attr(s, key):
    v = s.attr(key)
    if v is None:
        raise KeyError(key)
    return str(v)


@in_capi_context
def sym_set_attr(s, key, value):
    s._set_attr(**{key: value})


# ---------------------------------------------------------------- KVStore
@in_capi_context
def kv_create(type_name):
    return _mx().kv.create(type_name)


@in_capi_context
def kv_type(kv):
    return getattr(kv, "type", getattr(kv, "name", "local"))


@in_capi_context
def kv_rank(kv):
    return int(getattr(kv, "rank", 0))


@in_capi_context
def kv_num_workers(kv):
    return int(getattr(kv, "num_workers", 1))


@in_capi_context
def kv_init(kv, keys, arrays):
    kv.init(list(keys), list(arrays))


@in_capi_context
def kv_push(kv, keys, arrays, priority):
    kv.push(list(keys), list(arrays), priority=priority)


@in_capi_context
def kv_pull(kv, keys, arrays):
    kv.pull(list(keys), out=list(arrays))


@in_capi_context
def kv_pushpull(kv, keys, values, outs):
    kv.pushpull(list(keys), list(values), out=list(outs))


@in_capi_context
def kv_broadcast(kv, keys, values, outs):
    kv.broadcast(list(keys), list(values), out=list(outs))


@in_capi_context
def kv_set_compression(kv, params_json):
    kv.set_gradient_compression(json.loads(params_json))


# --------------------------------------------------------------- Profiler
@in_capi_context
def profiler_set_config(params_json):
    _mx().profiler.set_config(**json.loads(params_json))


@in_capi_context
def profiler_set_state(state):
    _mx().profiler.set_state(state)


@in_capi_context
def profiler_dump(finished):
    _mx().profiler.dump(bool(finished))


@in_capi_context
def profiler_summary():
    return _mx().profiler.dumps()


# ------------------------------------------------------------------- misc
@in_capi_context
def random_seed(seed):
    _mx().nd.random.seed(int(seed))


@in_capi_context
def list_all_op_names():
    from ..base import public_op_names
    return json.dumps(public_op_names(_mx().nd))


@in_capi_context
def load_lib(path):
    """≙ MXLoadLib: load a user extension library (registers custom ops)."""
    _mx().library.load(path)


@in_capi_context
def wait_all():
    _mx().nd.waitall()
