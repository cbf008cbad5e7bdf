"""``attn_roofline.serve``: for the batches that ran wholly inside the
profiled segment (their ``serve:batch`` spans), the attention forward's
work at its least time on the card, over the device time of the attention
kernels (``kernels/attention/*.json``) that started inside those batches.

A batch of ``bucket`` rows (padding included: the kernel computes them)
runs one forward a layer at (bucket, H, S, D): 4·B·H·D·S² FLOPs, bounded
by max(FLOPs / peak, bytes / bandwidth) (``devtrace.attention_bound_s``)."""
from __future__ import annotations

from portbench.core import devtrace


def read(t):
    seg = t.segment
    batches = t.segment_spans("serve:batch") if seg else []
    if not batches:
        return None
    within = [(r["start_us"], r["start_us"] + r["dur_us"]) for r in batches]
    spent = seg.device_time_s(t.attention_kernels, within)
    if not spent:
        return None
    cell = t.cell
    heads, head_dim, causal = cell.model.attention(cell.config)
    S = cell.traffic["seq_len"]
    item = cell.model.dtype(cell.config).itemsize
    layers = cell.model.layers(cell.config)
    bound = sum(layers * devtrace.attention_bound_s(
        r["args"]["bucket"], heads, S, head_dim, causal, item, False,
        t.peaks["bf16_flops"], t.peaks["hbm_bytes_per_s"]) for r in batches)
    return 100.0 * bound / spent
