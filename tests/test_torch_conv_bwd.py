"""The port's fused 3x3 conv backward (``ops/conv_bwd.py``) against the JAX
package, on the CPU, in float32.

On CPU tensors ``conv3x3_bwd`` runs K4's plain version
(``_conv_bwd_reference``); it is held against the JAX package's Pallas
kernel in interpret mode and against ``jax.vjp`` of the library conv at
``tests/test_conv_bwd.py``'s shapes with that file's tolerances (dx 1e-4, dw
1e-3, absolute and relative: the sums run over 9K and N*H*W terms in
another order). The kernel itself (K4, ``csrc/conv_bwd.cu``) runs only on
the card: the ``cuda``-marked tests hold it against the plain version there
and skip here; ``chip_smoke.py`` holds it at ResNet-50's shapes.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops import conv_bwd as jconv

import incubator_mxnet_tpu_torch as mxt  # noqa: F401
from incubator_mxnet_tpu_torch.ops import _kernels
from incubator_mxnet_tpu_torch.ops import conv_bwd as tconv

SHAPES = [(4, 8, 8, 16, 24), (2, 7, 7, 32, 32), (3, 5, 9, 8, 16)]
DX_TOL = dict(atol=1e-4, rtol=1e-4)
DW_TOL = dict(atol=1e-3, rtol=1e-3)


def _inputs(shape, seed=0, dtype="float32"):
    N, H, W, C, K = shape
    rng = onp.random.RandomState(seed)
    return (rng.randn(N, H, W, C).astype(dtype),
            rng.randn(3, 3, C, K).astype(dtype),
            rng.randn(N, H, W, K).astype(dtype))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K4 is CUDA and has no CPU mode "
                    "(chip_smoke.py holds it on the card)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_the_jax_kernel_and_vjp(shape):
    x, w, dy = _inputs(shape)
    dx, dw = tconv.conv3x3_bwd(*(torch.from_numpy(a) for a in (x, dy, w)))
    assert dx.dtype == dw.dtype == torch.float32
    kx, kw = jconv.conv3x3_bwd(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(w),
                               interpret=True)
    _, vjp = jax.vjp(jconv._conv_fwd_ref, jnp.asarray(x), jnp.asarray(w))
    vx, vw = vjp(jnp.asarray(dy))
    for rx, rw in ((kx, kw), (vx, vw)):
        onp.testing.assert_allclose(dx.numpy(), onp.asarray(rx), **DX_TOL)
        onp.testing.assert_allclose(dw.numpy(), onp.asarray(rw), **DW_TOL)


@pytest.mark.parametrize("shape", [(2, 6, 6, 8, 8), (1, 5, 7, 16, 8)])
def test_conv3x3_s1_forward_and_grad_match_jax(shape):
    """The forward (library conv) and the gradient of sum(y^2) through
    autograd, which takes K4's route (here its plain version)."""
    x, w, _ = _inputs(shape, seed=1)

    def loss(x_, w_):
        return jnp.sum(jconv.conv3x3_s1(x_, w_) ** 2)
    ref_y = jconv._conv_fwd_ref(jnp.asarray(x), jnp.asarray(w))
    rx, rw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y = tconv.conv3x3_s1(tx, tw)
    onp.testing.assert_allclose(y.detach().numpy(), onp.asarray(ref_y),
                                atol=1e-5, rtol=1e-5)
    (y ** 2).sum().backward()
    onp.testing.assert_allclose(tx.grad.numpy(), onp.asarray(rx), **DX_TOL)
    onp.testing.assert_allclose(tw.grad.numpy(), onp.asarray(rw), **DW_TOL)


def test_legality_gate():
    legal = tconv.conv3x3_bwd_legal
    assert legal((4, 8, 8, 16), (3, 3, 16, 24))
    # refused by the JAX package's gate too (tests/test_conv_bwd.py)
    assert not legal((4, 8, 8, 16), (3, 3, 16, 24), stride=(2, 2))
    assert not legal((4, 8, 8, 16), (1, 1, 16, 24))
    assert not legal((4, 8, 8, 10), (3, 3, 10, 24))
    # the rest of the Hopper gate
    assert not legal((4, 8, 8, 16), (3, 3, 16, 12))
    assert not legal((4, 8, 8, 16), (3, 3, 8, 24))
    assert not legal((4, 8, 8, 16), (3, 3, 16, 24), padding=(0, 0))
    assert not legal((4, 8, 8, 16), (3, 3, 16, 24), dilation=(2, 2))
    assert not legal((4, 8, 8, 16), (3, 3, 16, 24), groups=2)
    assert not legal((8, 16), (3, 3, 16, 24))
    assert not legal((4, 8, 8, 16), (3, 3, 16, 24), dtype=torch.float64)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert legal((4, 8, 8, 16), (3, 3, 16, 24), dtype=dtype)
    # no memory budget: conv5 (C = K = 512), which the TPU gate refuses
    assert legal((256, 7, 7, 512), (3, 3, 512, 512), dtype=torch.bfloat16)
    assert not jconv.conv3x3_bwd_legal((256, 7, 7, 512), (3, 3, 512, 512),
                                       itemsize=2)


def test_opt_out_takes_the_library_gradient(monkeypatch):
    """MXTPU_CONV_BWD_PALLAS=0 routes conv3x3_s1's backward to the library
    conv's gradient; on (the default) it goes through conv3x3_bwd once."""
    x, w, _ = _inputs((2, 5, 5, 8, 16), seed=2)
    calls = []
    real = tconv.conv3x3_bwd

    def spy(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(tconv, "conv3x3_bwd", spy)
    grads, seen = {}, {}
    for gate in ("1", "0"):
        monkeypatch.setenv("MXTPU_CONV_BWD_PALLAS", gate)
        tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
        (tconv.conv3x3_s1(tx, tw) ** 2).sum().backward()
        grads[gate] = (tx.grad, tw.grad)
        seen[gate] = len(calls)
    assert seen == {"1": 1, "0": 1}       # the opt-out added no call
    torch.testing.assert_close(grads["0"][0], grads["1"][0], **DX_TOL)
    torch.testing.assert_close(grads["0"][1], grads["1"][1], **DW_TOL)
    assert not tconv.conv3x3_bwd_legal((2, 5, 5, 8), (3, 3, 8, 16))


@pytest.mark.parametrize("bad", ["shape", "dtype", "layout", "device"])
def test_kernel_wrapper_checks_inputs_before_launch(bad):
    """K4's wrapper refuses what the kernel does not take before anything
    is built; the checks do not depend on the device."""
    x, w, dy = (torch.from_numpy(a) for a in _inputs((2, 4, 4, 8, 16)))
    if bad == "shape":
        dy = dy[..., :8].contiguous()
    elif bad == "dtype":
        w = w.double()
    elif bad == "layout":
        x = x.transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        tconv._conv_bwd_cuda(x, dy, w)
    assert tconv.SOURCE not in _kernels._libs


@pytest.mark.parametrize("m,c,k", [(256 * 56 * 56, 64, 64),
                                   (256 * 28 * 28, 128, 128),
                                   (256 * 14 * 14, 256, 256),
                                   (256 * 7 * 7, 512, 512), (7, 8, 8),
                                   (3 * 5 * 9, 8, 16)])
def test_wgrad_split_covers_every_pixel(m, c, k):
    splits, chunk = tconv._wgrad_split(m, c, k)
    assert splits >= 1 and chunk % 32 == 0
    assert (splits - 1) * chunk < m <= splits * chunk
    tiles = 9 * -(-c // 64) * -(-k // 64)
    assert splits == 1 or splits * tiles <= 2 * 132 * 8


def test_bytes_match_jax():
    for shape, k in (((256, 56, 56, 64), 64), ((256, 7, 7, 512), 512)):
        assert tconv.conv3x3_bytes(shape, k) == jconv.conv3x3_bytes(shape, k)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((3, 5, 9, 8, 16), torch.float32),
                                         ((2, 7, 7, 32, 32), torch.float32),
                                         ((8, 14, 14, 64, 64),
                                          torch.bfloat16)] + [
    (shape, dt) for dt in (torch.bfloat16, torch.float16)
    for shape in ((3, 5, 9, 8, 16), (2, 7, 7, 40, 24), (4, 13, 11, 24, 72))])
def test_kernel_matches_plain_on_the_card(cuda_device, shape, dtype):
    """K4 against its plain version on the same card inputs: fp32 within
    1e-4 of max|plain| (summation order), bf16/fp16 within one rounding of
    the type (2^-7 bf16, 2^-10 fp16, relative) plus 1e-3 of max|plain|;
    dx and dw identical across two launches (no atomics). The odd C and K
    (8, 16, 24, 40, 72) leave the tensor-core kernels' 64-wide tiles ragged,
    so their copies are zero-filled by column as well as by row."""
    x, w, dy = (torch.from_numpy(a).to(cuda_device, dtype)
                for a in _inputs(shape, seed=3))
    _kernels.reset_launches()
    got = tconv.conv3x3_bwd(x, dy, w)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["conv_bwd"] == 1
    rtol = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}[dtype]
    share = 1e-4 if dtype == torch.float32 else 1e-3
    for g, r in zip(got, tconv._conv_bwd_reference(x, dy, w)):
        assert g.dtype == dtype
        g, r = g.float(), r.float()
        assert bool(((g - r).abs() <= rtol * r.abs()
                     + share * r.abs().max()).all())
    again = tconv.conv3x3_bwd(x, dy, w)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_conv3x3_s1_backward_launches_the_kernel_once(cuda_device):
    x, w, _ = (torch.from_numpy(a).to(cuda_device).requires_grad_()
               for a in _inputs((2, 6, 6, 16, 16), seed=4))
    y = tconv.conv3x3_s1(x, w)
    _kernels.reset_launches()
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES.get("conv_bwd", 0) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("interpret", [None, False, True])
def test_interpret_still_launches_k4_on_cuda(cuda_device, interpret):
    """The reference's ``interpret`` picks Pallas's interpret mode, which
    runs the kernel's own arithmetic; on CUDA tensors the port launches K4
    whatever it says, and answers the same bits."""
    x, w, dy = (torch.from_numpy(a).to(cuda_device)
                for a in _inputs((2, 7, 7, 32, 32), seed=5))
    want = tconv.conv3x3_bwd(x, dy, w)
    _kernels.reset_launches()
    got = tconv.conv3x3_bwd(x, dy, w, interpret=interpret)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES.get("conv_bwd", 0) == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
