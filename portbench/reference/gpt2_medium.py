"""Plain PyTorch reference of GPT-2 medium as ``configs/gpt2_medium.json``
runs it, on parameters named as the port names them. fp32; imports
nothing of the port.

Pre-LN decoder blocks (x + attn(ln1 x); x + fc2(gelu(fc1(ln2 x)))),
learned positions, causal attention, ``ln_f`` and the head tied to
``tok_embed``; the exact GELU and no dropout, as ``assumed`` lists.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import plain


def clm(cfg, precision):
    """Task ``clm``: ``fn(params, ids, labels)``, the next-token
    cross-entropy summed over every position."""
    ar = plain.Arith(precision)
    eps = cfg["run"]["layer_norm_eps"]
    H = cfg["n_head"]

    def fn(w, ids, labels):
        S = ids.shape[1]
        pos = torch.arange(S, device=ids.device)
        x = ar.rnd(F.embedding(ids.long(), w["model.tok_embed.weight"]) +
                   F.embedding(pos, w["model.pos_embed.weight"]))
        for i in range(cfg["n_layer"]):
            lp = "model.layers.%d." % i
            x = ar.rnd(x + plain.attention(
                plain.layer_norm(x, w[lp + "ln1.gamma"], w[lp + "ln1.beta"],
                                 eps, ar), w, lp + "attn.", H, True, ar))
            h = plain.layer_norm(x, w[lp + "ln2.gamma"], w[lp + "ln2.beta"],
                                 eps, ar)
            x = ar.rnd(x + plain.linear(plain.gelu(plain.linear(
                h, w[lp + "fc1.weight"], w[lp + "fc1.bias"], ar), ar),
                w[lp + "fc2.weight"], w[lp + "fc2.bias"], ar))
        x = plain.layer_norm(x, w["model.ln_f.gamma"], w["model.ln_f.beta"],
                             eps, ar)
        return plain.cross_entropy_sum(x, w["model.tok_embed.weight"], None,
                                       labels, ar)
    return fn
