"""Plain PyTorch pieces of the references: fp32 with TF32 off, no kernels,
no cache, no batching but blocks of rows. Imports nothing of the port.

``Arith(precision)`` is the one switch. ``"fp32"`` is the reference.
``"fp8"`` is its control: the reference computed in float8 e4m3, the step
below the configurations' bfloat16, as the program computes in bfloat16.
Every tensor is held in fp8 with one scale a tensor: each matrix product's
operands, the output of every operation (products, norms, activations,
softmax, residual sums, embeddings) and, in the backward, the gradient
that flows into each of them. Arithmetic inside an operation stays in
fp32, as a product accumulates in fp32 on the card. ``"fp8_gemm"`` rounds
only the products' operands (fp8 matrix products in an fp32 reference): a
milder step, read beside the control for the record.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # largest finite float8 e4m3fn


def highest_precision():
    """fp32 products in fp32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x):
    """``x`` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), back in fp32."""
    scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g)
        return (torch.matmul(qg, qb.transpose(-1, -2)),
                torch.matmul(qa.transpose(-1, -2), qg))


class _Fp8Round(torch.autograd.Function):
    """A tensor held in fp8: rounded on the way forward, its gradient
    rounded on the way back."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


class Arith:
    """How a reference computes: ``mm`` multiplies, ``rnd`` holds an
    operation's output in the precision."""

    def __init__(self, precision):
        if precision == "fp32":
            self.mm, self.rnd = torch.matmul, (lambda x: x)
        elif precision == "fp8":
            self.mm, self.rnd = _Fp8Matmul.apply, _Fp8Round.apply
        elif precision == "fp8_gemm":
            self.mm, self.rnd = _Fp8Matmul.apply, (lambda x: x)
        else:
            raise ValueError("unknown precision %r" % precision)


def linear(x, w, b, ar):
    """``x Wᵀ + b`` with W (out, in), as gluon's Dense."""
    y = ar.mm(x, w.t())
    return ar.rnd(y if b is None else y + b)


def layer_norm(x, gamma, beta, eps, ar):
    return ar.rnd(F.layer_norm(x, (x.shape[-1],), gamma, beta, eps))


def gelu(x, ar):
    """The exact (erf) GELU."""
    return ar.rnd(F.gelu(x))


def attention(x, w, prefix, heads, causal, ar):
    """Multi-head self-attention with q, k, v and proj Dense layers named
    ``prefix + {query,key,value,proj}.{weight,bias}``: softmax(QKᵀ/√D) V
    over every pair, or the lower triangle when ``causal``."""
    B, S, U = x.shape
    D = U // heads

    def split(name):
        return linear(x, w[prefix + name + ".weight"],
                      w[prefix + name + ".bias"], ar) \
            .view(B, S, heads, D).transpose(1, 2)
    q, k, v = split("query"), split("key"), split("value")
    s = ar.rnd(ar.mm(q, k.transpose(-1, -2)) / math.sqrt(D))
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = ar.rnd(torch.softmax(s, dim=-1))
    o = ar.rnd(ar.mm(p, v)).transpose(1, 2).reshape(B, S, U)
    return linear(o, w[prefix + "proj.weight"], w[prefix + "proj.bias"], ar)


def cross_entropy_sum(h, head_w, head_b, labels, ar):
    """The sum over tokens of the softmax cross-entropy of ``h`` projected
    by the (V, U) head."""
    logits = linear(h, head_w, head_b, ar)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(), reduction="sum")


def train(params, batches, loss_sum, opt, rows_per_block,
          served_dtype=None, on_grad=None):
    """Adam over ``batches`` (one step each), as the port's Adam computes
    it: ``m = β1 m + (1-β1) g``, ``v = β2 v + (1-β2) g²``, ``w -= lr
    √(1-β2ᵗ)/(1-β1ᵗ) · m/(√v + ε)``, where g is the gradient of the mean
    loss over every token, summed over blocks of ``rows_per_block`` rows.
    ``params`` ({name: fp32 leaf}) are the fp32 masters, updated in place.
    With ``served_dtype`` (the configuration's bf16) the net holds its
    weights in that type, as multi-precision training does: each step's
    forward and gradient run at the masters rounded to it, and the change
    is that of the rounded weights. ``on_grad(t, {name: gradient})`` sees
    each step's gradient. Returns (the loss of each step, {name: the norm
    of step 1's gradient}, {name: the norm of the net's weights' change
    over all the steps})."""
    names = list(params)

    def served():
        if served_dtype is None:
            return params
        return {k: p.to(served_dtype).float() for k, p in params.items()}
    start = {k: p.detach().clone() for k, p in served().items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2 = opt["beta1"], opt["beta2"]
    lr, eps = opt["learning_rate"], opt["epsilon"]
    losses, first = [], None
    for t, batch in enumerate(batches, 1):
        with torch.no_grad():
            leaves = {k: p.detach().clone() for k, p in served().items()}
        for p in leaves.values():
            p.requires_grad_(True)
        rows = batch[0].shape[0]
        tokens = batch[-1].numel()
        total = torch.zeros((), device=batch[0].device)
        for r in range(0, rows, rows_per_block):
            block = [x[r:r + rows_per_block] for x in batch]
            loss = loss_sum(leaves, *block) / tokens
            loss.backward()
            total += loss.detach()
        losses.append(total)
        with torch.no_grad():
            grads = {k: leaves[k].grad if leaves[k].grad is not None
                     else torch.zeros_like(leaves[k]) for k in names}
            del leaves
            if first is None:
                first = torch.stack([grads[k].norm() for k in names])
            if on_grad is not None:
                on_grad(t, grads)
            lr_t = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
            for k in names:
                m[k].mul_(b1).add_(grads[k], alpha=1 - b1)
                v[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
                params[k].sub_(lr_t * m[k] / (v[k].sqrt() + eps))
            del grads
    with torch.no_grad():
        now = served()
        change = torch.stack([(now[k] - start[k]).norm() for k in names])
    first, change = first.tolist(), change.tolist()
    return ([float(x) for x in torch.stack(losses).tolist()],
            dict(zip(names, first)), dict(zip(names, change)))


def forward_blocks(fn, inputs, rows_per_block):
    """``fn(*block)`` over blocks of rows, concatenated, without a
    gradient."""
    outs = []
    with torch.no_grad():
        for r in range(0, inputs[0].shape[0], rows_per_block):
            outs.append(fn(*[x[r:r + rows_per_block] for x in inputs]))
    return torch.cat(outs)
