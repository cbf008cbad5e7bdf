"""GPT-2 medium as the port runs it (``gpt2_medium.json`` beside this
file).

Task ``clm``: causal LM pre-training, ``FeaturesView(GPTModel)`` into
``ChunkedLMLoss`` (the head tied to ``tok_embed``, fused with the chunked
cross-entropy of ``ops/lm_ce.py``), next-token labels.

The port is imported inside ``build`` only.
"""
from __future__ import annotations

import torch


def dims(cfg):
    return dict(V=cfg["vocab_size"], U=cfg["n_embd"], L=cfg["n_layer"],
                H=cfg["n_head"], F=cfg["run"]["hidden_size"],
                P=cfg["n_positions"])


def dtype(cfg):
    return getattr(torch, cfg["run"]["dtype"])


def param_specs(cfg, task):
    """[(name, shape, init)] of every parameter, named as the port's
    ``collect_params()`` names them under ``FeaturesView``."""
    if task != "clm":
        raise ValueError("gpt2_medium has no task %r" % task)
    d = dims(cfg)
    U, F = d["U"], d["F"]
    specs = [("model.tok_embed.weight", (d["V"], U), "normal"),
             ("model.pos_embed.weight", (d["P"], U), "normal")]
    for i in range(d["L"]):
        lp = "model.layers.%d." % i
        specs += [(lp + "ln1.gamma", (U,), "ones"),
                  (lp + "ln1.beta", (U,), "zeros")]
        for n in ("query", "key", "value", "proj"):
            specs += [(lp + "attn.%s.weight" % n, (U, U), "normal"),
                      (lp + "attn.%s.bias" % n, (U,), "zeros")]
        specs += [(lp + "ln2.gamma", (U,), "ones"),
                  (lp + "ln2.beta", (U,), "zeros"),
                  (lp + "fc1.weight", (F, U), "normal"),
                  (lp + "fc1.bias", (F,), "zeros"),
                  (lp + "fc2.weight", (U, F), "normal"),
                  (lp + "fc2.bias", (U,), "zeros")]
    specs += [("model.ln_f.gamma", (U,), "ones"),
              ("model.ln_f.beta", (U,), "zeros")]
    return specs


def matmul_params(cfg, task):
    """12·U² a layer at F = 4U, plus the tied head's V·U."""
    d = dims(cfg)
    return d["L"] * (4 * d["U"] ** 2 + 2 * d["U"] * d["F"]) + d["V"] * d["U"]


def train_flops_per_token(cfg, task, seq_len):
    """6 × matmul parameters + 12·L·S·U halved (causal: S(S+1)/2 pairs,
    taken as S²/2)."""
    d = dims(cfg)
    return 6.0 * matmul_params(cfg, task) + 6.0 * d["L"] * seq_len * d["U"]


def forward_flops_per_token(cfg, task, seq_len):
    d = dims(cfg)
    return 2.0 * matmul_params(cfg, task) + 2.0 * d["L"] * seq_len * d["U"]


def attention(cfg):
    d = dims(cfg)
    return d["H"], d["U"] // d["H"], True


def layers(cfg):
    return dims(cfg)["L"]


def build(mxt, cfg, task, ctx):
    """(net, loss_fn, n_net_inputs) on ``ctx`` in the configuration's
    dtype, parameters zero until the harness loads the seed's weights."""
    from incubator_mxnet_tpu_torch import models
    if task != "clm":
        raise ValueError("gpt2_medium has no task %r" % task)
    d, run = dims(cfg), cfg["run"]
    gpt = models.GPTModel(vocab_size=d["V"], units=d["U"],
                          hidden_size=d["F"], num_layers=d["L"],
                          num_heads=d["H"], max_length=d["P"],
                          attention=run["attention"])
    net = models.FeaturesView(gpt)
    net.initialize(mxt.init.Zero(), ctx=ctx)
    net.cast(run["dtype"])
    return net, models.ChunkedLMLoss(gpt), 1


def make_batch(cfg, traffic, gen, device):
    """(ids, labels), each (B, S) int32: a stream of B × (S + 1) tokens,
    the labels the next token of each position."""
    B, S = traffic["batch"], traffic["seq_len"]
    stream = torch.randint(0, cfg["vocab_size"], (B, S + 1), generator=gen,
                           device=device, dtype=torch.int32)
    return stream[:, :-1].contiguous(), stream[:, 1:].contiguous()
