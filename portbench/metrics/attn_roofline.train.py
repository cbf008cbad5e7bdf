"""``attn_roofline.train``: the attention work of the profiled segment's
steps at its least time on the card, over the device time of the
attention kernels that ran (those named in ``kernels/attention/*.json``).

The work is fixed by the shapes: each step runs, in each layer, one
forward (4·B·H·D·pairs FLOPs) and one backward (8·B·H·D·pairs) at
(B, H, S, D), pairs S² or S(S+1)/2 when causal; each bounded by
max(FLOPs / peak, bytes / bandwidth) (``devtrace.attention_bound_s``)."""
from __future__ import annotations

from portbench.core import devtrace


def read(t):
    seg = t.segment
    spent = seg.device_time_s(t.attention_kernels) if seg else 0.0
    if not spent or not t.segment_steps:
        return None
    cell = t.cell
    heads, head_dim, causal = cell.model.attention(cell.config)
    B, S = cell.traffic["batch"], cell.traffic["seq_len"]
    item = cell.model.dtype(cell.config).itemsize
    calls = t.segment_steps * cell.model.layers(cell.config)
    bound = calls * sum(devtrace.attention_bound_s(
        B, heads, S, head_dim, causal, item, bwd, t.peaks["bf16_flops"],
        t.peaks["hbm_bytes_per_s"]) for bwd in (False, True))
    return 100.0 * bound / spent
