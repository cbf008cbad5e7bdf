"""Self-contained ONNX protobuf codec (counterpart of
``incubator_mxnet_tpu/contrib/onnx_proto.py``, carried over: no ``onnx``
package is needed). A bfloat16 initializer reads back as float32 (exact):
the port needs no ``ml_dtypes``.

Implements the wire format (varint / length-delimited fields) for the subset
of onnx.proto3 messages the exporter/importer uses. Field numbers follow the
stable ONNX IR schema (onnx/onnx.proto, IR version 8 era):

  ModelProto:   ir_version=1, producer_name=2, producer_version=3, graph=7,
                opset_import=8
  OperatorSetIdProto: domain=1, version=2
  GraphProto:   node=1, name=2, initializer=5, input=11, output=12,
                value_info=13
  NodeProto:    input=1, output=2, name=3, op_type=4, attribute=5, domain=7
  AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, strings=9,
                type=20  (FLOAT=1 INT=2 STRING=3 TENSOR=4 FLOATS=6 INTS=7
                STRINGS=8)
  TensorProto:  dims=1, data_type=2, name=8, raw_data=9
                (FLOAT=1 UINT8=2 INT8=3 INT32=6 INT64=7 BOOL=9 FLOAT16=10
                 DOUBLE=11 BFLOAT16=16)
  ValueInfoProto: name=1, type=2
  TypeProto:    tensor_type=1;  TypeProto.Tensor: elem_type=1, shape=2
  TensorShapeProto: dim=1;  Dimension: dim_value=1, dim_param=2
"""
from __future__ import annotations

import struct

import numpy as onp

# ---------------------------------------------------------------- wire
def _varint(n):
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field, wire):
    return _varint((field << 3) | wire)


def f_varint(field, value):
    return _tag(field, 0) + _varint(int(value))


def f_bytes(field, data):
    if isinstance(data, str):
        data = data.encode()
    return _tag(field, 2) + _varint(len(data)) + data


def f_float(field, value):
    return _tag(field, 5) + struct.pack("<f", float(value))


def parse(buf):
    """Generic decode: {field: [values]}; length-delimited values stay bytes."""
    out = {}
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wire == 1:
            v = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        else:
            raise ValueError("unsupported wire type %d" % wire)
        out.setdefault(field, []).append(v)
    return out


def _signed(v):
    """Protobuf int64: negative values ride as 10-byte unsigned varints."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _read_varint(buf, i):
    shift, val = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


# ---------------------------------------------------------------- dtypes
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64 = 1, 2, 3, 6, 7
DT_BOOL, DT_FLOAT16, DT_DOUBLE, DT_BFLOAT16 = 9, 10, 11, 16

_NP2ONNX = {"float32": DT_FLOAT, "uint8": DT_UINT8, "int8": DT_INT8,
            "int32": DT_INT32, "int64": DT_INT64, "bool": DT_BOOL,
            "float16": DT_FLOAT16, "float64": DT_DOUBLE,
            "bfloat16": DT_BFLOAT16}
_ONNX2NP = {v: k for k, v in _NP2ONNX.items()}


# ---------------------------------------------------------------- messages
def tensor(name, arr):
    arr = onp.ascontiguousarray(arr)
    dt = _NP2ONNX[str(arr.dtype)]
    body = b"".join(f_varint(1, d) for d in arr.shape)
    body += f_varint(2, dt)
    body += f_bytes(8, name)
    body += f_bytes(9, arr.tobytes())  # raw_data covers bf16 too (2B/elem)
    return body


def attr_int(name, v):
    return f_bytes(1, name) + f_varint(3, v) + f_varint(20, 2)


def attr_float(name, v):
    return f_bytes(1, name) + f_float(2, v) + f_varint(20, 1)


def attr_string(name, v):
    return f_bytes(1, name) + f_bytes(4, v) + f_varint(20, 3)


def attr_ints(name, vs):
    return (f_bytes(1, name) + b"".join(f_varint(8, v) for v in vs)
            + f_varint(20, 7))


def attr_tensor(name, arr):
    return f_bytes(1, name) + f_bytes(5, tensor("", arr)) + f_varint(20, 4)


def attr_strings(name, vs):
    return (f_bytes(1, name) + b"".join(f_bytes(9, v) for v in vs)
            + f_varint(20, 8))


def node(op_type, inputs, outputs, name="", attrs=()):
    body = b"".join(f_bytes(1, i) for i in inputs)
    body += b"".join(f_bytes(2, o) for o in outputs)
    if name:
        body += f_bytes(3, name)
    body += f_bytes(4, op_type)
    body += b"".join(f_bytes(5, a) for a in attrs)
    return body


def value_info(name, shape, dtype="float32"):
    dims = b"".join(f_bytes(1, f_varint(1, d)) for d in shape)
    shp = dims
    tensor_type = f_varint(1, _NP2ONNX[str(dtype)]) + f_bytes(2, shp)
    type_proto = f_bytes(1, tensor_type)
    return f_bytes(1, name) + f_bytes(2, type_proto)


def graph(name, nodes, inputs, outputs, initializers):
    body = b"".join(f_bytes(1, n) for n in nodes)
    body += f_bytes(2, name)
    body += b"".join(f_bytes(5, t) for t in initializers)
    body += b"".join(f_bytes(11, i) for i in inputs)
    body += b"".join(f_bytes(12, o) for o in outputs)
    return body


def model(graph_bytes, opset=13, producer="incubator_mxnet_tpu"):
    opset_b = f_bytes(1, "") + f_varint(2, opset)
    return (f_varint(1, 8)              # ir_version 8
            + f_bytes(2, producer)
            + f_bytes(7, graph_bytes)
            + f_bytes(8, opset_b))


# ---------------------------------------------------------------- readers
def read_model(buf):
    m = parse(buf)
    g = parse(m[7][0])
    return {
        "ir_version": m.get(1, [0])[0],
        "producer": m.get(2, [b""])[0].decode(),
        "graph": g,
    }


def read_nodes(g):
    out = []
    for nb in g.get(1, []):
        n = parse(nb)
        attrs = {}
        for ab in n.get(5, []):
            a = parse(ab)
            aname = a[1][0].decode()
            atype = a.get(20, [0])[0]
            if atype == 2:
                attrs[aname] = _signed(a[3][0])
            elif atype == 1:
                attrs[aname] = a[2][0]
            elif atype == 3:
                attrs[aname] = a[4][0].decode()
            elif atype == 7:
                attrs[aname] = [_signed(int(v)) for v in a.get(8, [])]
            elif atype == 8:
                attrs[aname] = [v.decode() for v in a.get(9, [])]
            elif atype == 4:
                attrs[aname] = read_tensor(parse(a[5][0]))
        out.append({
            "op_type": n[4][0].decode(),
            "inputs": [x.decode() for x in n.get(1, [])],
            "outputs": [x.decode() for x in n.get(2, [])],
            "name": n.get(3, [b""])[0].decode(),
            "attrs": attrs,
        })
    return out


def read_tensor(t):
    dims = tuple(int(d) for d in t.get(1, []))
    dt = t.get(2, [DT_FLOAT])[0]
    name = t.get(8, [b""])[0].decode()
    raw = t.get(9, [b""])[0]
    if _ONNX2NP[dt] == "bfloat16":
        bits = onp.frombuffer(raw, onp.uint16).astype(onp.uint32) << 16
        arr = bits.view(onp.float32).reshape(dims)
    else:
        arr = onp.frombuffer(raw, _ONNX2NP[dt]).reshape(dims)
    return name, arr


def read_initializers(g):
    return dict(read_tensor(parse(tb)) for tb in g.get(5, []))


def read_value_infos(g, field):
    out = []
    for vb in g.get(field, []):
        v = parse(vb)
        name = v[1][0].decode()
        shape, dtype = (), "float32"
        if 2 in v:
            tp = parse(v[2][0])
            if 1 in tp:
                tt = parse(tp[1][0])
                dtype = _ONNX2NP.get(tt.get(1, [DT_FLOAT])[0], "float32")
                if 2 in tt:
                    dims = []
                    for db in parse(tt[2][0]).get(1, []):
                        d = parse(db)
                        dims.append(int(d.get(1, [0])[0]))
                    shape = tuple(dims)
        out.append((name, shape, dtype))
    return out
