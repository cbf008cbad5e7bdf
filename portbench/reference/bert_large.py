"""Plain PyTorch reference of BERT-large as ``configs/bert_large.json``
runs it, on parameters named as the port names them. fp32; imports
nothing of the port.

The equations are the port's ``models.BERTModel`` (post-LN layers), with
the departures from the published model that the configuration lists
under ``assumed``: the position table added after ``embed_ln``, a relu
MLM transform, LayerNorm eps 1e-5, no dropout, the MLM loss over every
position.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import plain


def _features(w, cfg, ar, ids, types, p):
    eps = cfg["run"]["layer_norm_eps"]
    H = cfg["num_attention_heads"]
    S = ids.shape[1]
    x = ar.rnd(F.embedding(ids.long(), w[p + "word_embed.weight"]) +
               F.embedding(types.long(), w[p + "token_type_embed.weight"]))
    x = plain.layer_norm(x, w[p + "embed_ln.gamma"], w[p + "embed_ln.beta"],
                         eps, ar)
    x = ar.rnd(x + w[p + "encoder.position_weight"][:S])
    for i in range(cfg["num_hidden_layers"]):
        lp = p + "encoder.layer%d." % i
        h = plain.attention(x, w, lp + "attention_cell.", H, False, ar)
        x = plain.layer_norm(ar.rnd(x + h), w[lp + "ln1.gamma"],
                             w[lp + "ln1.beta"], eps, ar)
        h = plain.linear(plain.gelu(plain.linear(
            x, w[lp + "ffn1.weight"], w[lp + "ffn1.bias"], ar), ar),
            w[lp + "ffn2.weight"], w[lp + "ffn2.bias"], ar)
        x = plain.layer_norm(ar.rnd(x + h), w[lp + "ln2.gamma"],
                             w[lp + "ln2.beta"], eps, ar)
    return x


def mlm(cfg, precision):
    """Task ``mlm``: ``fn(params, ids, types, labels)``, the MLM
    cross-entropy summed over every position."""
    ar = plain.Arith(precision)
    eps = cfg["run"]["layer_norm_eps"]

    def fn(w, ids, types, labels):
        h = _features(w, cfg, ar, ids, types, "model.")
        h = ar.rnd(torch.relu(plain.linear(h, w["model.mlm_dense.weight"],
                                           w["model.mlm_dense.bias"], ar)))
        h = plain.layer_norm(h, w["model.mlm_ln.gamma"],
                             w["model.mlm_ln.beta"], eps, ar)
        return plain.cross_entropy_sum(h, w["model.mlm_decoder.weight"],
                                       w["model.mlm_decoder.bias"], labels,
                                       ar)
    return fn


def span_qa(cfg, precision):
    """Task ``span_qa``: ``fn(params, ids, types) -> (B, S, 2)``, the SQuAD
    start/end logits of the served block."""
    ar = plain.Arith(precision)

    def fn(w, ids, types):
        h = _features(w, cfg, ar, ids, types, "")
        return plain.linear(h, w["qa_outputs.weight"], w["qa_outputs.bias"],
                            ar)
    return fn
