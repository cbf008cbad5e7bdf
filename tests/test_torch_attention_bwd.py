"""The port's flash-attention backward (kernels K2/K3's module) against the
JAX package, on the CPU.

The JAX side differentiates its ``custom_vjp``s with ``jax.vjp``, its
Pallas kernels in interpret mode with 128-row blocks (so S = 256 runs a
grid of several blocks). The port's ``torch.autograd.Function``s run the
kernels' plain versions, because the tensors lie on the CPU; the CUDA
kernels are held against the same plain versions on the card by
chip_smoke.py and by the ``cuda``-marked test here, which skips without a
card. Tolerance: 1e-5 of the largest reference gradient, in float32 — both
sides recompute fp32 probabilities from the forward's LSE and differ in the
order of the sums. In bf16 the port rounds p and ds to bf16 where its
tensor-core kernels do and the JAX recompute does not; that test holds the
gradients normwise (see its docstring).
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


def _rel_fro(got, ref):
    """Relative Frobenius error ||got - ref|| / ||ref|| in float64."""
    got, ref = (onp.asarray(x, dtype="float64") for x in (got, ref))
    return onp.linalg.norm(got - ref) / max(onp.linalg.norm(ref), 1e-30)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_grads_match_jax_normwise(causal):
    """In bf16 the port's plain backward rounds p and ds to bf16 where the
    tensor-core kernels do (before ``pᵀ dO``, ``dsᵀ q`` and ``ds k``); the
    JAX recompute keeps them in fp32. One bf16 rounding of each term is an
    error of about 2^-8/sqrt(3) (0.23 %) of a gradient's spread, and each
    gradient is rounded to bf16 once more on both sides: within 1e-2
    relative Frobenius error per gradient."""
    q, k, v, do = _inputs(2, 2, 256, 64, seed=11 + causal)
    ref = _jax_grads(lambda a, b, c: JA.flash_attention(a, b, c, causal),
                     *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                     (jnp.asarray(do, jnp.bfloat16),))
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_()
                  for x in (q, k, v))
    TA.flash_attention(tq, tk, tv, causal).backward(
        torch.from_numpy(do).bfloat16())
    for t, r in zip((tq, tk, tv), ref):
        assert t.grad.dtype == torch.bfloat16
        got = t.grad.float().numpy()
        assert onp.isfinite(got).all()
        assert _rel_fro(got, onp.asarray(r.astype(jnp.float32))) <= 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2 and K3 have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("S, D, causal, dtype, with_g_lse", [
    (130, 64, True, "bfloat16", False),
    (300, 128, False, "float16", True)])
def test_kernels_match_plain_on_the_card(cuda_device, S, D, causal, dtype,
                                         with_g_lse):
    """K2 and K3 (tensor cores in bf16/fp16) against the plain backward on
    the same inputs, which rounds p and ds where the kernels do:
    elementwise within one rounding of the type (2^-7 bf16, 2^-10 fp16,
    relative) of the gradient and of each term whose p or ds is rounded (a
    p or ds close to a rounding boundary may round to neighbouring values
    on the two sides, whose fp32 sums run in another order), plus 1e-3 of
    the largest plain gradient; and within 1e-2 (bf16) or 2e-3 (fp16)
    relative Frobenius error of the fp32-p recompute."""
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x).to(cuda_device, dt)
                   for x in _inputs(1, 4, S, D, seed=S))
    scale = 1.0 / math.sqrt(D)
    g_lse = torch.from_numpy(onp.random.RandomState(1).randn(1, 4, S)
                             .astype("float32")).to(cuda_device) \
        if with_g_lse else None
    o, lse = TA._fa_reference(q, k, v, causal, scale)
    delta = TA._bwd_delta(o, do, g_lse)
    dk, dv = TA._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    dq = TA._flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    ref = TA._fa_bwd_reference(q, k, v, o, lse, do, causal, scale, g_lse)
    ref32 = TA._fa_bwd_reference(q.float(), k.float(), v.float(), o.float(),
                                 lse, do.float(), causal, scale, g_lse)
    # magnitudes of the rounded terms: |dS| |k|, |dS|ᵀ |q|, Pᵀ |dO|
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~TA._causal_keep(S, S, s.device), -math.inf)
    p = torch.exp(s - lse.reshape(1, 4, S, 1))
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2))
               - delta.reshape(1, 4, S, 1)) * scale).abs()
    terms = (torch.matmul(ds, kf.abs()),
             torch.matmul(ds.transpose(-1, -2), qf.abs()),
             torch.matmul(p.transpose(-1, -2), dof.abs()))
    rtol = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -10
    for got, want, want32, term in zip((dq, dk, dv), ref, ref32, terms):
        assert got.dtype == dt and bool(torch.isfinite(got).all())
        got, want = got.float(), want.float()
        bound = rtol * (want.abs() + term) + 1e-3 * want.abs().max()
        assert bool(((got - want).abs() <= bound).all())
        assert _rel_fro(got.cpu().numpy(), want32.cpu().numpy()) <= (
            1e-2 if dt == torch.bfloat16 else 2e-3)


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
