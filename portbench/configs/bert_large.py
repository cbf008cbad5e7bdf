"""BERT-large as the port runs it (``bert_large.json`` beside this file).

Tasks:

- ``mlm``: pre-training, ``FeaturesView(BERTModel)`` into
  ``ChunkedMLMLoss`` (the untied, biased ``mlm_decoder`` fused with the
  chunked cross-entropy of ``ops/lm_ce.py``) over every position;
- ``span_qa``: SQuAD serving, the BERT trunk (``word_embed`` +
  ``token_type_embed`` -> ``embed_ln`` -> ``BERTEncoder``) with a
  ``Dense(2, flatten=False)`` start/end head, built here from the port's
  public blocks.

The port is imported inside ``build`` only: the harness's CPU tests import
this file to read its formulas.
"""
from __future__ import annotations

import torch


def dims(cfg):
    return dict(V=cfg["vocab_size"], U=cfg["hidden_size"],
                L=cfg["num_hidden_layers"], H=cfg["num_attention_heads"],
                F=cfg["intermediate_size"], P=cfg["max_position_embeddings"],
                T=cfg["type_vocab_size"])


def dtype(cfg):
    return getattr(torch, cfg["run"]["dtype"])


def _prefix(task):
    if task == "mlm":
        return "model."
    if task == "span_qa":
        return ""
    raise ValueError("bert_large has no task %r" % task)


def param_specs(cfg, task):
    """[(name, shape, init)] of every parameter, named as the port's
    ``collect_params()`` names them."""
    d = dims(cfg)
    U, F, p = d["U"], d["F"], _prefix(task)
    specs = [(p + "word_embed.weight", (d["V"], U), "normal"),
             (p + "token_type_embed.weight", (d["T"], U), "normal"),
             (p + "embed_ln.gamma", (U,), "ones"),
             (p + "embed_ln.beta", (U,), "zeros"),
             (p + "encoder.position_weight", (d["P"], U), "normal")]
    for i in range(d["L"]):
        lp = p + "encoder.layer%d." % i
        for n in ("query", "key", "value", "proj"):
            specs += [(lp + "attention_cell.%s.weight" % n, (U, U), "normal"),
                      (lp + "attention_cell.%s.bias" % n, (U,), "zeros")]
        specs += [(lp + "ln1.gamma", (U,), "ones"),
                  (lp + "ln1.beta", (U,), "zeros"),
                  (lp + "ffn1.weight", (F, U), "normal"),
                  (lp + "ffn1.bias", (F,), "zeros"),
                  (lp + "ffn2.weight", (U, F), "normal"),
                  (lp + "ffn2.bias", (U,), "zeros"),
                  (lp + "ln2.gamma", (U,), "ones"),
                  (lp + "ln2.beta", (U,), "zeros")]
    if task == "mlm":
        specs += [(p + "mlm_dense.weight", (U, U), "normal"),
                  (p + "mlm_dense.bias", (U,), "zeros"),
                  (p + "mlm_ln.gamma", (U,), "ones"),
                  (p + "mlm_ln.beta", (U,), "zeros"),
                  (p + "mlm_decoder.weight", (d["V"], U), "normal"),
                  (p + "mlm_decoder.bias", (d["V"],), "zeros")]
    else:
        specs += [("qa_outputs.weight", (2, U), "normal"),
                  ("qa_outputs.bias", (2,), "zeros")]
    return specs


def readout(task):
    """The parameter through which a served reply reads the last hidden
    state (``compare.serving``)."""
    if task != "span_qa":
        raise ValueError("bert_large serves no task %r" % task)
    return "qa_outputs.weight"


def matmul_params(cfg, task):
    """Weights that enter a matrix multiplication (no tables, biases or
    norms): 12·U² a layer (q, k, v, proj and the two FFN matrices at
    F = 4U), plus the task's head."""
    d = dims(cfg)
    n = d["L"] * (4 * d["U"] ** 2 + 2 * d["U"] * d["F"])
    if task == "mlm":
        return n + d["U"] ** 2 + d["V"] * d["U"]
    return n + 2 * d["U"]


def train_flops_per_token(cfg, task, seq_len):
    """6 × matmul parameters + 12·L·S·U (attention's QKᵀ and PV, forward
    and backward). No recomputation and no embedding gather."""
    d = dims(cfg)
    return 6.0 * matmul_params(cfg, task) + \
        12.0 * d["L"] * seq_len * d["U"]


def forward_flops_per_token(cfg, task, seq_len):
    """2 × matmul parameters + 4·L·S·U."""
    d = dims(cfg)
    return 2.0 * matmul_params(cfg, task) + 4.0 * d["L"] * seq_len * d["U"]


def attention(cfg):
    """(heads, head size, causal) of every layer's attention."""
    d = dims(cfg)
    return d["H"], d["U"] // d["H"], False


def layers(cfg):
    return dims(cfg)["L"]


def build(mxt, cfg, task, ctx):
    """The port's net on ``ctx`` in the configuration's dtype, parameters
    zero until the harness loads the seed's weights. ``mlm`` returns
    (net, loss_fn, n_net_inputs); ``span_qa`` the served block."""
    from incubator_mxnet_tpu_torch import models
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.gluon.block import HybridBlock
    d, run = dims(cfg), cfg["run"]
    if task == "mlm":
        bert = models.BERTModel(
            vocab_size=d["V"], units=d["U"], hidden_size=d["F"],
            num_layers=d["L"], num_heads=d["H"], max_length=d["P"],
            dropout=run["dropout"], attention=run["attention"])
        net = models.FeaturesView(bert)
        loss_fn = models.ChunkedMLMLoss(bert)
    elif task == "span_qa":
        class SpanQA(HybridBlock):
            """BERT's trunk and SQuAD's start/end head: (ids, types) ->
            (B, S, 2) logits."""

            def __init__(self):
                super().__init__()
                self.word_embed = nn.Embedding(d["V"], d["U"])
                self.token_type_embed = nn.Embedding(d["T"], d["U"])
                self.embed_ln = nn.LayerNorm(in_channels=d["U"])
                self.encoder = models.BERTEncoder(
                    d["U"], d["F"], d["L"], d["H"], d["P"],
                    dropout=run["dropout"], attention=run["attention"])
                self.qa_outputs = nn.Dense(2, flatten=False,
                                           in_units=d["U"])

            def forward(self, ids, types=None):
                # without types (int8 calibration feeds the ids alone), no
                # segment embedding, as BERTModel.features
                x = self.word_embed(ids)
                if types is not None:
                    x = x + self.token_type_embed(types)
                return self.qa_outputs(self.encoder(self.embed_ln(x)))
        net = SpanQA()
    else:
        raise ValueError("bert_large has no task %r" % task)
    net.initialize(mxt.init.Zero(), ctx=ctx)
    net.cast(run["dtype"])
    if task == "mlm":
        return net, loss_fn, 2
    return net


def _types(gen, device, rows, seq_len):
    """Segment ids: 0 up to a split drawn in [S/4, 3S/4), 1 after it."""
    split = torch.randint(seq_len // 4, 3 * seq_len // 4, (rows, 1),
                          generator=gen, device=device)
    pos = torch.arange(seq_len, device=device).unsqueeze(0)
    return (pos >= split).to(torch.int32)


def make_batch(cfg, traffic, gen, device):
    """One ``mlm`` batch (ids, types, labels), each (B, S) int32: labels
    are the drawn tokens, the inputs those tokens with 15 % of positions
    replaced by [MASK] (id 103)."""
    B, S, V = traffic["batch"], traffic["seq_len"], cfg["vocab_size"]
    labels = torch.randint(0, V, (B, S), generator=gen, device=device,
                           dtype=torch.int32)
    masked = torch.rand((B, S), generator=gen, device=device) < 0.15
    ids = torch.where(masked, torch.full_like(labels, 103), labels)
    return ids, _types(gen, device, B, S), labels


def make_requests(cfg, traffic, gen, device):
    """``distinct_requests`` SQuAD-shaped requests: (ids, types), each
    (N, S) int32 on ``device``; every token is real (the flash path takes
    no mask)."""
    N, S = traffic["distinct_requests"], traffic["seq_len"]
    ids = torch.randint(0, cfg["vocab_size"], (N, S), generator=gen,
                        device=device, dtype=torch.int32)
    return ids, _types(gen, device, N, S)
