"""The port's flash-attention forward (kernel K1's module) against the JAX
package, on the CPU.

The JAX side runs its Pallas kernel in interpret mode; the port's wrapper
runs the kernel's plain version, because the tensors lie on the CPU. The
CUDA kernel itself is held against the same plain version on the card by
chip_smoke.py. Tolerance: 1e-5 absolute and relative in float32 — both
sides compute fp32 scores and an fp32 softmax, and differ only in the
order of the sums.
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
