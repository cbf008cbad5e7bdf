"""``mfu.train``, ``mfu.serve``: the whole model's share of the card's
bf16 peak over the window, from the configuration's FLOP formulas:

- training: the model FLOPs a token (``train_flops_per_token``: 6 ×
  matmul parameters + 12·L·S·U, halved attention when causal, no
  recomputation) times the tokens of the window's steps;
- serving: the forward FLOPs a token (``forward_flops_per_token``: 2 ×
  matmul parameters + 4·L·S·U) times the tokens of the sequences answered
  in the window (padding rows excluded)."""
from __future__ import annotations


def read(t):
    cell = t.cell
    task, S = cell.traffic["task"], cell.traffic["seq_len"]
    if t.tokens:
        flops = cell.model.train_flops_per_token(cell.config, task, S) * \
            t.tokens
    elif t.served:
        flops = cell.model.forward_flops_per_token(cell.config, task, S) * \
            S * t.served
    else:
        return None
    return 100.0 * flops / t.window_s / t.peaks["bf16_flops"]
