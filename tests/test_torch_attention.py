"""The port's flash-attention forward (kernel K1's module) against the JAX
package, on the CPU.

The JAX side runs its Pallas kernel in interpret mode; the port's wrapper
runs the kernel's plain version, because the tensors lie on the CPU. The
CUDA kernel itself is held against the same plain version on the card by
chip_smoke.py and by the ``cuda``-marked tests here, which skip without a
card. Tolerance: 1e-5 absolute and relative in float32 — both sides
compute fp32 scores and an fp32 softmax, and differ only in the order of
the sums.

In bf16/fp16 the tensor-core kernel rounds p to the input type before
``P V``, against the running max of its online softmax; the JAX kernel and
the plain version keep p in fp32. ``_tc_forward`` emulates the kernel's
arithmetic on the CPU, so the tolerance the card is held to (one rounding
of the type on the output and on each term ``p_ij |v_j| / l_i``, and 1e-2
bf16 / 2e-3 fp16 relative Frobenius error) is argued here first.
"""
import math
import os

import numpy as onp
import pytest
import torch

import jax.numpy as jnp

from incubator_mxnet_tpu.ops import attention as JA
from incubator_mxnet_tpu_torch.ops import attention as TA

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_INTERPRET", "1")


def _qkv(B, H, S, D, seed=0):
    rng = onp.random.RandomState(seed)
    return [rng.randn(B, H, S, D).astype("float32") for _ in range(3)]


def _jax_fa_call(q, k, v, causal, scale):
    S = q.shape[2]
    block = 128 if S % 128 == 0 else S
    out, lse = JA._fa_call(*(jnp.asarray(x) for x in (q, k, v)), causal,
                           scale, block, block)
    return onp.asarray(out), onp.asarray(lse)


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_fa_call_matches_jax_kernel(S, D, causal):
    q, k, v = _qkv(2, 2, S, D, seed=S + D)
    scale = 1.0 / math.sqrt(D)
    ref_out, ref_lse = _jax_fa_call(q, k, v, causal, scale)
    out, lse = TA._fa_call(*(torch.from_numpy(x) for x in (q, k, v)),
                           causal, scale)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert tuple(lse.shape) == ref_lse.shape == (4, 1, S)
    onp.testing.assert_allclose(out.numpy(), ref_out, **TOL)
    onp.testing.assert_allclose(lse.numpy(), ref_lse, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fa_call_fully_masked_row_matches_jax_kernel(causal):
    """A row whose every score is -inf: out 0 and lse -inf on both sides
    (the l >= 1e-37 clamp and the m_safe / p = 0 rules)."""
    q, k, v = _qkv(1, 2, 128, 64, seed=3)
    k = onp.abs(k) + 0.1            # all scores of a -inf q row are -inf
    q[0, 1, 5, :] = -onp.inf
    scale = 0.125
    ref_out, ref_lse = _jax_fa_call(q, k, v, causal, scale)
    out, lse = TA._fa_call(*(torch.from_numpy(x) for x in (q, k, v)),
                           causal, scale)
    assert onp.isneginf(ref_lse[1, 0, 5]) and onp.all(ref_out[0, 1, 5] == 0)
    onp.testing.assert_allclose(out.numpy(), ref_out, **TOL)
    onp.testing.assert_allclose(lse.numpy(), ref_lse, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_composites_match_jax(causal):
    q, k, v = _qkv(2, 2, 96, 32, seed=7)
    scale = 0.2
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    onp.testing.assert_allclose(
        TA._blocked_reference(tq, tk, tv, causal, scale).numpy(),
        onp.asarray(JA._blocked_reference(jq, jk, jv, causal, scale)), **TOL)
    out, lse = TA._dense_with_lse(tq, tk, tv, causal, scale)
    rout, rlse = JA._dense_with_lse(jq, jk, jv, causal, scale)
    onp.testing.assert_allclose(out.numpy(), onp.asarray(rout), **TOL)
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(rlse), **TOL)


@pytest.mark.parametrize("shape,causal", [((2, 2, 128, 64), True),
                                          ((1, 2, 100, 64), False),
                                          ((1, 2, 128, 48), True)])
def test_flash_attention_matches_jax(shape, causal):
    """Legal and refused shapes (ragged S, odd D) agree with the JAX entry
    point, which routes them to its kernel or to its composite."""
    q, k, v = _qkv(*shape, seed=11)
    ref = onp.asarray(JA.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                         causal))
    out = TA.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal)
    onp.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_legality_gate_is_shape_only():
    assert TA.flash_attention_legal((8, 8, 512, 128))
    assert TA.flash_attention_legal((1, 8, 8192, 128), (1, 8, 8192, 128),
                                    (1, 8, 8192, 128))
    assert TA.flash_attention_legal((1, 2, 1000, 64))      # ragged S is legal
    assert not TA.flash_attention_legal((1, 2, 128, 32))   # unsupported D
    assert not TA.flash_attention_legal((1, 2, 128, 64), (1, 2, 64, 64))
    assert not TA.flash_attention_legal((2, 128, 64))


def test_bf16_cpu_path_keeps_the_input_type():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(1, 2, 64, 64))
    out, lse = TA._fa_call(q, k, v, True, 0.125)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, _ = TA._fa_call(q.float(), k.float(), v.float(), True, 0.125)
    assert torch.equal(out, ref.bfloat16())


def test_cuda_wrapper_refuses_grad_before_launch():
    """The kernel wrapper takes CUDA tensors only: a CPU input that requires
    grad raises before anything is built, and its gradient goes through
    flash_attention's autograd Function (the plain versions on the CPU)."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(1, 1, 64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        TA._flash_fwd_cuda(q, k, v, False, 0.125)
    TA.flash_attention(q, k, v, False, 0.125).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


@pytest.mark.parametrize("bad", ["shape", "width", "dtype", "layout"])
def test_cuda_wrapper_checks_inputs_before_launch(bad):
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 64, 64))
    if bad == "shape":
        k = k[:, :, :32].contiguous()
    elif bad == "width":
        q, k, v = (t[..., :32].contiguous() for t in (q, k, v))
    elif bad == "dtype":
        q, k, v = (t.double() for t in (q, k, v))
    else:
        q = q.transpose(2, 3)
        k, v = k.transpose(2, 3), v.transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        TA._flash_fwd_cuda(q, k, v, False, 0.125)


def test_kernel_build_runs_nvcc_once_per_source_content(tmp_path, monkeypatch):
    """The build plumbing, with a stand-in nvcc that records its arguments:
    sm_90a flags, one library per source digest, no rebuild when present."""
    from incubator_mxnet_tpu_torch.ops import _kernels
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    calls = tmp_path / "calls.txt"
    nvcc = bindir / "nvcc"
    nvcc.write_text('#!/bin/sh\necho "$@" >> %s\nout=""\nwhile [ $# -gt 0 ]; do'
                    ' if [ "$1" = "-o" ]; then out="$2"; fi; shift; done\n'
                    'touch "$out"\n' % calls)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "build"))
    paths = _kernels.build(TA.SOURCE)
    assert os.path.exists(paths[TA.SOURCE])
    assert paths[TA.SOURCE].startswith(str(tmp_path / "build"))
    args = calls.read_text().split()
    assert "arch=compute_90a,code=sm_90a" in args and "-shared" in args
    assert _kernels.build(TA.SOURCE) == paths          # cached: no second run
    assert len(calls.read_text().splitlines()) == 1


# ------------------------------------------------- tensor-core K1 (bf16/fp16)
TC_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
TC_NORM_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3}


def _tc_forward(q, k, v, causal, scale):
    """The tensor-core K1's arithmetic on the CPU, for q, k, v in bf16 or
    fp16: fp32 scores scaled after the product, 64-wide kv tiles, the
    -inf-safe online softmax, p rounded to the input type against the
    running max before ``P V``, l summed from the unrounded p, out = acc /
    max(l, 1e-37) rounded once, lse = m + log l in fp32 (B*H, 1, S). (The
    kernel takes its exponentials in log2 units: the same numbers up to
    fp32 rounding.)"""
    B, H, S, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, D)
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, 64):
        s = torch.matmul(qf, kf[:, :, k0:k0 + 64].transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, k0 + s.shape[-1])[None, :]
            s = s.masked_fill(cols > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                            torch.zeros_like(m))
        alpha = torch.nan_to_num(alpha, nan=0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - m_safe),
                        torch.zeros_like(s))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(q.dtype).float(),
                                         vf[:, :, k0:k0 + 64])
        m = m_new
    l = l.clamp_min(1e-37)
    return (acc / l).to(q.dtype), (m + torch.log(l)).reshape(B * H, 1, S)


def _term_sums(q, k, v, causal, scale):
    """sum_j p_ij |v_j| / l_i with p, l as _fa_reference computes them (the
    per-term share of chip_smoke.py's hold_fwd bound)."""
    S = q.shape[2]
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        s = s.masked_fill(~TA._causal_keep(S, S, s.device), -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe),
                    torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    return torch.matmul(p, v.float().abs()) / l


def _hold_tc_out(got, q, k, v, causal, scale):
    """Raise unless a bf16/fp16 K1 ``out`` is within the bound the card's
    kernel is held to against _fa_reference (chip_smoke.py hold_fwd)."""
    ref, _ = TA._fa_reference(q, k, v, causal, scale)
    g, want = got.float(), ref.float()
    bound = 1e-4 + TC_RTOL[q.dtype] * (
        want.abs() + _term_sums(q, k, v, causal, scale))
    err = (g - want).abs()
    assert torch.isfinite(g).all()
    assert bool((err <= bound).all()), (err / bound).max().item()
    assert ((g - want).norm() / want.norm()).item() <= TC_NORM_TOL[q.dtype]
    return (err / bound).max().item()


def _tc_inputs(B, H, S, D, dtype, seed):
    return [torch.from_numpy(x).to(dtype) for x in _qkv(B, H, S, D, seed)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_tensor_core_arithmetic_matches_jax_kernel_normwise(dtype, causal):
    """The emulated tensor-core K1 against the JAX kernel (interpret mode,
    fp32 p) on the same bf16/fp16 inputs: rounding p against the running
    max and the output once stays within 1e-2 (bf16) / 2e-3 (fp16)
    relative Frobenius error, and lse within the fp32 tolerance."""
    q, k, v = _tc_inputs(2, 2, 256, 64, dtype, seed=21 + causal)
    scale = 0.125
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    ref_out, ref_lse = JA._fa_call(
        *(jnp.asarray(t.float().numpy(), jdt) for t in (q, k, v)), causal,
        scale, 128, 128)
    ref_out = onp.asarray(ref_out.astype(jnp.float32))
    out, lse = _tc_forward(q, k, v, causal, scale)
    got = out.float().numpy()
    assert onp.isfinite(got).all()
    rel = onp.linalg.norm(got - ref_out) / onp.linalg.norm(ref_out)
    assert rel <= TC_NORM_TOL[dtype]
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(ref_lse),
                                atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_tensor_core_arithmetic_within_the_per_term_bound(dtype, causal):
    """The emulated tensor-core K1 against the plain version (fp32 p)
    elementwise: within one rounding of the type of the output and of each
    term p_ij |v_j| / l_i, plus 1e-4 — the bound chip_smoke.py holds the
    kernel to — and normwise; lse within atol 2e-4 / rtol 1e-5."""
    q, k, v = _tc_inputs(2, 2, 256, 64, dtype, seed=31 + causal)
    scale = 0.125
    out, lse = _tc_forward(q, k, v, causal, scale)
    _hold_tc_out(out, q, k, v, causal, scale)
    _, ref_lse = TA._fa_reference(q, k, v, causal, scale)
    torch.testing.assert_close(lse, ref_lse, atol=2e-4, rtol=1e-5)


def test_tensor_core_arithmetic_keeps_a_fully_masked_row():
    """A bf16 row whose every score is -inf: out 0 and lse -inf in the
    emulated kernel as in the plain version, and the other rows held."""
    q, k, v = _tc_inputs(1, 2, 128, 64, torch.bfloat16, seed=3)
    k = k.abs() + 1.0
    q[0, 1, 5, :] = -1e38
    out, lse = _tc_forward(q, k, v, True, 0.125)
    assert torch.all(out[0, 1, 5] == 0) and torch.isneginf(lse[1, 0, 5])
    _hold_tc_out(out, q, k, v, True, 0.125)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 is CUDA and has no CPU mode "
                    "(chip_smoke.py holds it on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,causal,dtype", [
    (130, 64, True, torch.bfloat16),
    (300, 128, False, torch.float16)])
def test_kernel_matches_plain_on_the_card(cuda_device, S, D, causal, dtype):
    """The tensor-core K1 against its plain version on the same card
    inputs, within the per-term bound; lse within atol 2e-4 / rtol 1e-5."""
    from incubator_mxnet_tpu_torch.ops import _kernels
    q, k, v = (t.to(cuda_device) for t in _tc_inputs(1, 3, S, D, dtype, 41))
    scale = 1.0 / math.sqrt(D)
    _kernels.reset_launches()
    out, lse = TA._fa_call(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["flash_fwd"] == 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    _hold_tc_out(out, q, k, v, causal, scale)
    _, ref_lse = TA._fa_reference(q, k, v, causal, scale)
    torch.testing.assert_close(lse, ref_lse, atol=2e-4, rtol=1e-5)
