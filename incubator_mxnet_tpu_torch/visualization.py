"""Network visualization (counterpart of
``incubator_mxnet_tpu/visualization.py``; MXNet's
``python/mxnet/visualization.py``), also ``mx.viz``.

``plot_network`` gives the graph's DOT source from ``tojson()``, which is
the JAX package's, so the source is too. ``print_summary`` prints the
layer table with each node's output shape, inferred on meta tensors as
the executor infers them (on zeros on the CPU where an operator cannot
run on meta tensors), and each node's parameter count. MXNet's count, not
the JAX package's: the count takes arguments only, so BatchNorm counts
``gamma`` and ``beta``; its moving statistics are auxiliary states here
(arguments in the JAX package, which counts them too).
"""
from __future__ import annotations

import json

import numpy as onp
import torch

__all__ = ["print_summary", "plot_network"]


def _node_shapes(symbol, shape):
    """({argument: shape}, {node: output shape}) for the input shapes
    ``shape``; a label variable left out is (batch,), as at bind."""
    from . import autograd
    from .context import cpu
    from .ndarray import NDArray
    from .symbol.symbol import _evaluate, _infer

    got = _infer(symbol, {k: tuple(v) for k, v in shape.items()},
                 label_default=True)
    if got is None:
        raise ValueError("print_summary: the shapes given leave a variable "
                         "of %s unknown" % symbol.name)
    var_shapes, _ = got
    arg_shapes = {n: var_shapes[n] for n in symbol.list_arguments()}
    internals = [s for s in symbol.get_internals() if not s.is_var]
    for device in (torch.device("meta"), torch.device("cpu")):
        binds = {k: NDArray(torch.zeros(v, device=device))
                 for k, v in var_shapes.items()}
        try:
            with autograd.pause(train_mode=False), cpu():
                outs = _evaluate(internals, binds, cache={})
            break
        except (NotImplementedError, RuntimeError):
            if device.type == "cpu":
                raise
    return arg_shapes, {
        s.name: tuple((o[0] if isinstance(o, (list, tuple)) else o).shape)
        for s, o in zip(internals, outs)}


def print_summary(symbol, shape=None, line_length=120,
                  positions=(0.44, 0.64, 0.74, 1.0)):
    """Print the layer table (name and op, output shape, parameter count,
    inputs) and the total; ``shape`` ({'data': (...), ...}) gives the
    shapes. Returns the total parameter count."""
    nodes = json.loads(symbol.tojson())["nodes"]
    arg_shapes, out_shapes = ({}, {})
    if shape:
        arg_shapes, out_shapes = _node_shapes(symbol, shape)
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]
    positions = [int(line_length * p) for p in positions]

    def print_row(cells):
        line = ""
        for i, c in enumerate(cells):
            line += str(c)
            line = line[: positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(fields)
    print("=" * line_length)
    total = 0
    data_names = set(shape or ())
    for node in nodes:
        if node["op"] == "null":
            continue
        ins = [nodes[i[0]] for i in node["inputs"]]
        prev = ", ".join(n["name"] for n in ins)
        n_params = sum(int(onp.prod(arg_shapes[n["name"]])) for n in ins
                       if n["op"] == "null" and n["name"] in arg_shapes
                       and n["name"] not in data_names)
        total += n_params
        print_row(["%s (%s)" % (node["name"], node["op"]),
                   str(out_shapes.get(node["name"], "")), str(n_params), prev])
    print("=" * line_length)
    print("Total params: %d" % total)
    return total


def plot_network(symbol, title="plot", save_format="pdf", shape=None, dtype=None,
                 node_attrs=None, hide_weights=True):
    """The graph as DOT source (render it with graphviz where wanted)."""
    nodes = json.loads(symbol.tojson())["nodes"]
    lines = ["digraph %s {" % title, "  rankdir=BT;"]
    for i, node in enumerate(nodes):
        if node["op"] == "null" and hide_weights and node["name"] != "data":
            continue
        label = node["name"] if node["op"] == "null" else \
            "%s\\n%s" % (node["op"], node["name"])
        lines.append('  n%d [label="%s"];' % (i, label))
    for i, node in enumerate(nodes):
        if node["op"] == "null":
            continue
        for inp in node["inputs"]:
            src = nodes[inp[0]]
            if src["op"] == "null" and hide_weights and src["name"] != "data":
                continue
            lines.append("  n%d -> n%d;" % (inp[0], i))
    lines.append("}")
    return "\n".join(lines)
