"""Symbolic control flow (counterpart of
``incubator_mxnet_tpu/symbol/contrib.py``): ``foreach``, ``while_loop``
and ``cond``.

The body/cond/func callables run once, at graph construction, on
placeholder variables, which captures the loop's subgraph; its free
variables (closed-over parameter symbols) become inputs of the
control-flow node, so gradients reach them when the bound executor
differentiates. Execution goes to the port's ``nd.contrib`` control flow
(a Python loop that reads predicates on the host)."""
from __future__ import annotations

from .symbol import Symbol, Group, var, _auto_name
from ..ndarray import contrib as ndc

__all__ = ["foreach", "while_loop", "cond"]


def _subgraph(build, ph_names):
    """Run the builder on placeholders, return (out_syms, free_var_syms)."""
    outs = build()
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    g = Group(outs)
    var_nodes = {s.name: s for s in g.get_internals() if s.is_var}
    free = [var_nodes[n] for n in g.list_arguments() if n not in ph_names]
    return outs, free


def foreach(body, data, init_states):
    """body(data_sym, state_syms) -> (out, states). Returns (outs, states)."""
    data_list = list(data) if isinstance(data, (list, tuple)) else [data]
    states_list = list(init_states)
    ph_d = [var(_auto_name("foreach_data")) for _ in data_list]
    ph_s = [var(_auto_name("foreach_state")) for _ in states_list]
    ph_names = {p.name for p in ph_d + ph_s}

    box = {}

    def build():
        d_arg = ph_d if isinstance(data, (list, tuple)) else ph_d[0]
        out, new_states = body(d_arg, ph_s)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        box["n_out"] = len(outs)
        box["out_is_list"] = isinstance(out, (list, tuple))
        return outs + list(new_states)

    all_outs, free = _subgraph(build, ph_names)
    n_out, n_state = box["n_out"], len(states_list)
    sub = Group(all_outs)

    def op(*arrs):
        d = list(arrs[:len(data_list)])
        s = list(arrs[len(data_list):len(data_list) + n_state])
        extras = list(arrs[len(data_list) + n_state:])

        def nd_body(d_i, st):
            d_i = d_i if isinstance(d_i, list) else [d_i]
            bind = dict(zip([p.name for p in ph_d], d_i))
            bind.update(zip([p.name for p in ph_s], st))
            bind.update(zip([f.name for f in free], extras))
            cache = {}  # shared: nodes reused by several outputs run once
            res = [o.eval_imperative(bind, _cache=cache) for o in all_outs]
            out = res[:n_out] if box["out_is_list"] else res[0]
            return out, res[n_out:]

        d_arg = d if len(d) > 1 or isinstance(data, (list, tuple)) else d[0]
        outs, states = ndc.foreach(nd_body, d_arg, s)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        res = outs + list(states)
        return res[0] if len(res) == 1 else res

    node = Symbol(op=op, op_name="_foreach",
                  inputs=data_list + states_list + free,
                  num_outputs=n_out + n_state)
    outs = [node[i] for i in range(n_out)]
    states = [node[n_out + i] for i in range(n_state)]
    return (outs if box["out_is_list"] else outs[0]), states


def while_loop(cond_fn, func, loop_vars, max_iterations=None):
    """cond(*vars) -> scalar sym; func(*vars) -> (step_out, new_vars)."""
    loop_vars = list(loop_vars)
    ph_v = [var(_auto_name("while_var")) for _ in loop_vars]
    ph_names = {p.name for p in ph_v}

    box = {}

    def build():
        pred = cond_fn(*ph_v)
        out, new_vars = func(*ph_v)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        box["n_out"] = len(outs)
        box["out_is_list"] = isinstance(out, (list, tuple))
        return [pred] + outs + list(new_vars)

    all_outs, free = _subgraph(build, ph_names)
    n_out, n_var = box["n_out"], len(loop_vars)
    pred_sym, out_syms = all_outs[0], all_outs[1:1 + n_out]
    var_syms = all_outs[1 + n_out:]

    def op(*arrs):
        vs = list(arrs[:n_var])
        extras = list(arrs[n_var:])

        def bindings(vals):
            b = dict(zip([p.name for p in ph_v], vals))
            b.update(zip([f.name for f in free], extras))
            return b

        def nd_cond(*vals):
            return pred_sym.eval_imperative(bindings(list(vals)))

        def nd_func(*vals):
            b = bindings(list(vals))
            cache = {}
            outs = [o.eval_imperative(b, _cache=cache) for o in out_syms]
            new_vars = [v.eval_imperative(b, _cache=cache) for v in var_syms]
            out = outs if box["out_is_list"] else outs[0]
            return out, new_vars

        outs, final_vars = ndc.while_loop(nd_cond, nd_func, vs,
                                          max_iterations=max_iterations)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        res = outs + list(final_vars)
        return res[0] if len(res) == 1 else res

    node = Symbol(op=op, op_name="_while_loop", inputs=loop_vars + free,
                  num_outputs=n_out + n_var)
    outs = [node[i] for i in range(n_out)]
    finals = [node[n_out + i] for i in range(n_var)]
    return (outs if box["out_is_list"] else outs[0]), finals


def cond(pred, then_func, else_func):
    """pred: scalar Symbol; then/else: () -> Symbol or list of Symbols."""
    box = {}

    def build_then():
        out = then_func()
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        box["n_out"] = len(outs)
        box["is_list"] = isinstance(out, (list, tuple))
        return outs

    then_outs, then_free = _subgraph(build_then, set())
    else_outs, else_free = _subgraph(
        lambda: else_func(), set())
    if len(else_outs) != box["n_out"]:
        raise ValueError("cond branches must produce the same number of "
                         "outputs (%d vs %d)" % (box["n_out"], len(else_outs)))
    # dedupe free vars across branches by name
    free, seen = [], set()
    for f in then_free + else_free:
        if f.name not in seen:
            seen.add(f.name)
            free.append(f)
    n_out = box["n_out"]

    def op(pred_arr, *extras):
        bind = dict(zip([f.name for f in free], extras))

        def _branch(outs_syms):
            def run():
                cache = {}
                res = [o.eval_imperative(dict(bind), _cache=cache)
                       for o in outs_syms]
                return res if box["is_list"] else res[0]
            return run

        out = ndc.cond(pred_arr, _branch(then_outs), _branch(else_outs))
        if n_out == 1:
            return out[0] if isinstance(out, (list, tuple)) else out
        return list(out) if isinstance(out, (list, tuple)) else [out]

    node = Symbol(op=op, op_name="_cond", inputs=[pred] + free,
                  num_outputs=n_out)
    if n_out == 1:
        return node
    outs = [node[i] for i in range(n_out)]
    return outs if box["is_list"] else outs[0]
