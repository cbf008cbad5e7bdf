"""The port's ``nd`` operators against the JAX package's, entry by entry of
the JAX package's own sweep table, on the CPU.

For every entry of ``incubator_mxnet_tpu.test_utils._sweep_table()`` that
the port's trimmed copy (``incubator_mxnet_tpu_torch.test_utils``) holds,
the entry's own call runs through each package's ``nd`` on the same
``sweep_inputs``:

- forward in float32 and bfloat16, at the JAX package's ``SWEEP_TOLS``
  (its looser float32 row for "trans" entries; matmul-class entries under
  "highest" precision on the JAX side); a nondiff entry runs only float32,
  but the rounding family, as in the JAX package's sweep;
- gradients of ``sum(op)`` (summed over its outputs) in float32, through
  each package's ``attach_grad``/``record``/``backward``, at (1e-4, 1e-5)
  or (2e-3, 1e-4) for "trans" entries, the JAX package's grad sweep's.

The coverage tests hold the port's table to the reference's: every entry
is the reference's (same specs and options), and every reference entry
whose operator the port has is in it, but the ones listed in
``PORT_LEAVES_OUT`` with the reason.
"""
import contextlib

import jax
import numpy as onp
import pytest

from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import test_utils as jtu

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch import test_utils as ttu

REF = {jtu._norm_entry(e)[0]: jtu._norm_entry(e) for e in jtu._sweep_table()}
PORT = {e[0]: e for e in ttu._sweep_table()}
#: reference entries whose operator the port defines but the entry needs
#: what the port leaves out (ROADMAP.md §1 item 5 lists them)
PORT_LEAVES_OUT = {}
FLOAT_KINDS = ("f", "pos", "unit", "gt1", "perm", "pmf")


def _op_name(entry_name, opts):
    return opts.get("op", entry_name.partition("@")[0])


def _port_defines(name):
    target = tnd
    for part in name.split("."):
        target = getattr(target, part, None)
        if target is None:
            return False
    return callable(target)


def _jax_arrays(specs, inputs, dt):
    out = []
    for (_, kind), x in zip(specs, inputs):
        a = jnd.array(x)
        if kind in FLOAT_KINDS and dt != "float32":
            a = a.astype(dt)
        out.append(a)
    return out


def _precision(tag):
    return jax.default_matmul_precision("highest") if tag == "mm" \
        else contextlib.nullcontext()


def _sum_outputs(out):
    outs = out if isinstance(out, (list, tuple)) else [out]
    s = outs[0].sum()
    for x in outs[1:]:
        s = s + x.sum()
    return s


@pytest.mark.parametrize("entry", sorted(PORT))
def test_entry_matches_the_jax_package(entry):
    _, fn, specs, opts = REF[entry]
    base, _, tag = entry.partition("@")
    inputs = jtu.sweep_inputs(specs, 0)
    for dt in ("float32", "bfloat16"):
        if dt != "float32" and opts.get("nondiff") \
                and base not in jtu.TRANS_DTYPE_OK:
            continue
        rtol, atol = (jtu.SWEEP_TOLS_TRANS if tag == "trans"
                      else jtu.SWEEP_TOLS)[dt]
        with _precision(tag):
            want = jtu._norm_outputs(fn(jnd, *_jax_arrays(specs, inputs, dt)))
        with mxt.cpu():
            got = ttu._norm_outputs(fn(tnd, *ttu._sweep_arrays(
                specs, inputs, mxt.cpu(), dt)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape, (dt, g.shape, w.shape)
            onp.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                        err_msg="%s %s" % (entry, dt))
    if opts.get("nondiff") or not specs or not all(
            kind in FLOAT_KINDS for _, kind in specs):
        return
    rtol, atol = (2e-3, 1e-4) if tag == "trans" else (1e-4, 1e-5)
    with _precision(tag):
        arrs = [jnd.array(x) for x in inputs]
        for a in arrs:
            a.attach_grad()
        with jautograd.record():
            s = _sum_outputs(fn(jnd, *arrs))
        s.backward()
        want = [a.grad.asnumpy() for a in arrs]
    got = ttu._sum_grads(fn, inputs, mxt.cpu())
    for i, (g, w) in enumerate(zip(got, want)):
        onp.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                    err_msg="gradient %d of %s" % (i, entry))


def _same_specs(a, b):
    """Equal specs; a "const" spec's payload array compared by value."""
    if len(a) != len(b):
        return False
    for (shape, kind), (ref_shape, ref_kind) in zip(a, b):
        if kind != ref_kind:
            return False
        if kind == "const":
            if not onp.array_equal(shape[0], ref_shape[0]):
                return False
        elif shape != ref_shape:
            return False
    return True


def test_port_table_entries_are_the_references():
    for name, (_, _, specs, opts) in PORT.items():
        assert name in REF, name
        _, _, ref_specs, ref_opts = REF[name]
        assert _same_specs(specs, ref_specs) and opts == ref_opts, name


def test_port_table_holds_every_reference_entry_the_port_can_run():
    want = set()
    for name, (_, _, _, opts) in REF.items():
        op = _op_name(name, opts)
        if _port_defines(op) and op not in PORT_LEAVES_OUT:
            want.add(name)
    assert set(PORT) == want, (sorted(want - set(PORT)),
                               sorted(set(PORT) - want))
    assert all(_port_defines(op) for op in PORT_LEAVES_OUT)


def test_port_sweeps_agree_with_themselves_on_the_cpu():
    """The port's own sweeps (the chip's phase runs them against the card)
    walk every entry without an error: CPU against CPU, all three dtypes,
    and the float32 gradients."""
    rows = ttu.op_consistency_sweep(ctx_list=[mxt.cpu(), mxt.cpu()])
    assert {r[0] for r in rows} == {n.partition("@")[0] for n in PORT}
    assert [r for r in rows if r[3] != "ok"] == []
    assert {r[1] for r in rows} == {"float32", "bfloat16", "float16"}
    grads = ttu.grad_consistency_sweep(ctx_list=[mxt.cpu(), mxt.cpu()])
    assert grads and [r for r in grads if r[2] != "ok"] == []
