"""Weights and inputs made from the seed, on the device, in a few large
calls. The same seed gives the same values on the same device type, so the
program and the reference are handed the same weights: the program's set
into its parameters, the reference's made again from the seed once the
program is gone.

A parameter spec is ``(name, shape, init)`` with ``init`` one of
``"normal"`` (N(0, 0.02²), BERT's and GPT-2's published initialiser
scale), ``"zeros"`` or ``"ones"``. Every ``"normal"`` parameter is a slice
of one draw, taken in the specs' order.
"""
from __future__ import annotations

import math

import torch

INIT_STD = 0.02


def generator(seed, device, stream=0):
    """A generator on ``device`` seeded from the run's seed and a stream
    number (weights 0, inputs 1, the sample 2), so the streams never share
    draws. Seeds up to 2**63 are taken whole."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))
    return g


def make(specs, seed, device, dtype):
    """{name: tensor} in ``dtype`` on ``device``. The draw is in fp32 and
    rounded to ``dtype`` once; a reference that asks for fp32 after the
    program's bf16 gets the bf16 values widened (``widened``)."""
    n = sum(math.prod(shape) for _, shape, init in specs if init == "normal")
    flat = torch.randn(n, generator=generator(seed, device), device=device,
                       dtype=torch.float32)
    flat.mul_(INIT_STD)
    flat = flat.to(dtype)
    out, at = {}, 0
    for name, shape, init in specs:
        if init == "normal":
            size = math.prod(shape)
            out[name] = flat[at:at + size].view(shape)
            at += size
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        else:
            raise ValueError("unknown init %r of %s" % (init, name))
    return out


def widened(specs, seed, device, served_dtype):
    """The weights as the program is given them (``served_dtype``), widened
    to fp32 leaf by leaf, each a tensor of its own."""
    low = make(specs, seed, device, served_dtype)
    return {k: v.float().clone() for k, v in low.items()}


def load_into(net, weights):
    """Copy ``weights`` into the net's parameters by name; every parameter
    of the net has to be given, and nothing else."""
    params = net.collect_params()
    missing = sorted(set(params) - set(weights))
    extra = sorted(set(weights) - set(params))
    if missing or extra:
        raise KeyError("weights do not match the net: missing %s, extra %s"
                       % (missing[:5], extra[:5]))
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError("%s: net shape %s, weights %s" % (
                name, tuple(p.shape), tuple(weights[name].shape)))
        p.set_data(weights[name])
