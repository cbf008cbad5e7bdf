"""The port's flash-attention backward (kernels K2/K3's module) against the
JAX package, on the CPU.

The JAX side differentiates its ``custom_vjp``s with ``jax.vjp``, its
Pallas kernels in interpret mode with 128-row blocks (so S = 256 runs a
grid of several blocks). The port's ``torch.autograd.Function``s run the
kernels' plain versions, because the tensors lie on the CPU; the CUDA
kernels are held against the same plain versions on the card by
chip_smoke.py. Tolerance: 1e-5 of the largest reference gradient, in
float32 — both sides recompute fp32 probabilities from the forward's LSE
and differ in the order of the sums.
"""
import math

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops import attention as JA
from incubator_mxnet_tpu_torch.ops import attention as TA


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_INTERPRET", "1")
    monkeypatch.setenv("MXTPU_FLASH_BLOCK_Q", "128")
    monkeypatch.setenv("MXTPU_FLASH_BLOCK_K", "128")


def _inputs(B, H, S, D, seed, n=4):
    rng = onp.random.RandomState(seed)
    return [rng.randn(B, H, S, D).astype("float32") for _ in range(n)]


def _assert_close(got, ref, rel=1e-5):
    ref = onp.asarray(ref)
    assert got.shape == ref.shape and onp.isfinite(got).all()
    err = onp.abs(got - ref).max()
    assert err <= rel * max(onp.abs(ref).max(), 1e-30), err


def _port_grads(fn, q, k, v, cts):
    """Gradients of ``fn(q, k, v)`` (one output or a tuple) for the given
    cotangents, through the port's autograd."""
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    outs = fn(tq, tk, tv)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cts])
    return [t.grad.numpy() for t in (tq, tk, tv)]


def _jax_grads(fn, q, k, v, cts):
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    cts = tuple(jnp.asarray(c) for c in cts)
    return vjp(cts if len(cts) > 1 else cts[0])


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grads_match_jax(S, causal):
    q, k, v, do = _inputs(2, 2, S, 64, seed=S + causal)
    ref = _jax_grads(lambda a, b, c: JA.flash_attention(a, b, c, causal),
                     q, k, v, (do,))
    got = _port_grads(lambda a, b, c: TA.flash_attention(a, b, c, causal),
                      q, k, v, (do,))
    for g, r in zip(got, ref):
        _assert_close(g, r)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_lse_grads_match_jax(causal):
    """A nonzero LSE cotangent folds into delta on both sides."""
    q, k, v, do = _inputs(2, 2, 256, 64, seed=5 + causal)
    g_lse = onp.random.RandomState(9).randn(2, 2, 256).astype("float32")
    ref = _jax_grads(lambda a, b, c: JA.flash_attention_lse(a, b, c, causal),
                     q, k, v, (do, g_lse))
    got = _port_grads(
        lambda a, b, c: TA.flash_attention_lse(a, b, c, causal),
        q, k, v, (do, g_lse))
    for g, r in zip(got, ref):
        _assert_close(g, r)
    out, lse = TA.flash_attention_lse(*(torch.from_numpy(x)
                                        for x in (q, k, v)), causal)
    rout, rlse = JA.flash_attention_lse(*(jnp.asarray(x) for x in (q, k, v)),
                                        causal)
    _assert_close(out.numpy(), rout)
    _assert_close(lse.numpy(), rlse)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_row_gives_zero_finite_grads(causal):
    """Row 5 of head 1 scores -inf against every key (the product
    overflows): p = 0 there, so its dQ is zero and no gradient is NaN, on
    both sides."""
    q, k, v, do = _inputs(1, 2, 128, 64, seed=3)
    k = onp.abs(k) + 1.0
    q[0, 1, 5, :] = -1e38
    ref = _jax_grads(lambda a, b, c: JA.flash_attention(a, b, c, causal),
                     q, k, v, (do,))
    got = _port_grads(lambda a, b, c: TA.flash_attention(a, b, c, causal),
                      q, k, v, (do,))
    assert onp.all(onp.asarray(ref[0])[0, 1, 5] == 0)
    assert onp.all(got[0][0, 1, 5] == 0)
    for g, r in zip(got, ref):
        _assert_close(g, r)


def test_plain_backward_matches_autograd_of_the_composite():
    """_fa_bwd_reference against torch autograd through _dense_with_lse,
    at a ragged S, with both cotangents."""
    q, k, v, do = _inputs(1, 2, 100, 64, seed=4)
    g_lse = onp.random.RandomState(2).randn(1, 2, 100).astype("float32")
    scale = 1.0 / math.sqrt(64)
    tq, tk, tv = (torch.from_numpy(x).double().requires_grad_()
                  for x in (q, k, v))
    out, lse = TA._dense_with_lse(tq, tk, tv, True, scale)
    torch.autograd.backward([out, lse], [torch.from_numpy(do).double(),
                                         torch.from_numpy(g_lse).double()])
    tq32, tk32, tv32 = (torch.from_numpy(x) for x in (q, k, v))
    o, lse32 = TA._fa_reference(tq32, tk32, tv32, True, scale)
    got = TA._fa_bwd_reference(tq32, tk32, tv32, o, lse32,
                               torch.from_numpy(do), True, scale,
                               torch.from_numpy(g_lse))
    for g, r in zip(got, (tq.grad, tk.grad, tv.grad)):
        _assert_close(g.numpy(), r.float().numpy(), rel=1e-5)


def test_composite_route_is_differentiable():
    """A shape the kernels refuse (D = 48) takes the composite, and its
    gradients match JAX's composite route."""
    q, k, v, do = _inputs(1, 2, 128, 48, seed=6)
    ref = _jax_grads(lambda a, b, c: JA.flash_attention(a, b, c, True),
                     q, k, v, (do,))
    got = _port_grads(lambda a, b, c: TA.flash_attention(a, b, c, True),
                      q, k, v, (do,))
    for g, r in zip(got, ref):
        _assert_close(g, r)


def test_attention_with_lse_routes_by_shape():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 128, 64, 1, 3))
    out, lse = TA.attention_with_lse(q, k, v, True)
    ref_out, ref_lse = TA._dense_with_lse(q, k, v, True, 0.125)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    narrow = [t[..., :32].contiguous() for t in (q, k, v)]
    assert not TA.flash_attention_supported(narrow[0].shape)
    out, lse = TA.attention_with_lse(*narrow)
    assert out.shape == (1, 2, 128, 32) and lse.shape == (1, 2, 128)
    with pytest.raises(ValueError, match="kernel-legal"):
        TA.flash_attention_lse(*narrow)


@pytest.mark.parametrize("bad", ["shape", "dtype", "lse", "device"])
def test_backward_wrappers_check_inputs_before_launch(bad):
    """K2's and K3's wrappers refuse what the kernels do not take before
    anything is built: the checks do not depend on the device."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 2, 64, 64, 8))
    lse = torch.zeros(2, 1, 64)
    delta = torch.zeros(2, 1, 64)
    if bad == "shape":
        do = do[:, :, :32].contiguous()
    elif bad == "dtype":
        do = do.double()
    elif bad == "lse":
        lse = lse.reshape(2, 64)
    for fn in (TA._flash_bwd_dkv_cuda, TA._flash_bwd_dq_cuda):
        with pytest.raises((ValueError, TypeError)):
            fn(q, k, v, do, lse, delta, False, 0.125)
