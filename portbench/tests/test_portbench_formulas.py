"""The yardstick's arithmetic against counts made by hand at tiny sizes:
FLOPs a token, attention bounds, busy time and idle gaps."""
from __future__ import annotations

import math

import pytest

from portbench.core import devtrace, spec


def _tiny_bert():
    return dict(vocab_size=10, hidden_size=4, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=8,
                max_position_embeddings=16, type_vocab_size=2)


def _tiny_gpt():
    return dict(vocab_size=10, n_embd=4, n_layer=2, n_head=2,
                n_positions=16, run={"hidden_size": 8})


def test_bert_matmul_params_by_hand():
    m = spec.model_module("bert_large")
    cfg = _tiny_bert()
    # a layer: q, k, v, proj 4·4² = 64, ffn1 + ffn2 2·4·8 = 64
    assert m.matmul_params(cfg, "mlm") == 2 * 128 + 16 + 40
    assert m.matmul_params(cfg, "span_qa") == 2 * 128 + 8
    # the matrices of param_specs: every 2-D weight but the tables
    specs = m.param_specs(cfg, "mlm")
    mats = sum(math.prod(s) for n, s, _ in specs
               if len(s) == 2 and "embed" not in n and "position" not in n)
    assert mats == m.matmul_params(cfg, "mlm")


def test_bert_flops_a_token_by_hand():
    m = spec.model_module("bert_large")
    cfg = _tiny_bert()
    P = 2 * 128 + 16 + 40
    assert m.train_flops_per_token(cfg, "mlm", 16) == 6 * P + 12 * 2 * 16 * 4
    assert m.forward_flops_per_token(cfg, "span_qa", 16) == \
        2 * (2 * 128 + 8) + 4 * 2 * 16 * 4
    assert m.attention(cfg) == (2, 2, False)


def test_bert_large_published_flops():
    cell = spec.Cell("bert_large.pretrain_s512")
    m, cfg = cell.model, cell.config
    assert m.matmul_params(cfg, "mlm") == \
        24 * 12 * 1024 ** 2 + 1024 ** 2 + 30522 * 1024
    assert m.train_flops_per_token(cfg, "mlm", 512) == pytest.approx(
        2.157e9, rel=1e-3)


def test_gpt_flops_a_token_by_hand():
    m = spec.model_module("gpt2_medium")
    cfg = _tiny_gpt()
    P = 2 * 128 + 40       # the tied head's V·U
    assert m.matmul_params(cfg, "clm") == P
    # causal: half of 12·L·S·U
    assert m.train_flops_per_token(cfg, "clm", 16) == 6 * P + 6 * 2 * 16 * 4
    assert m.attention(cfg) == (2, 2, True)
    specs = m.param_specs(cfg, "clm")
    mats = sum(math.prod(s) for n, s, _ in specs
               if len(s) == 2 and "embed" not in n)
    assert mats + 40 == P


def test_gpt2_medium_published_flops():
    cell = spec.Cell("gpt2_medium.pretrain_s1024")
    assert cell.model.train_flops_per_token(
        cell.config, "clm", 1024) == pytest.approx(2.272e9, rel=1e-3)


def test_attention_bound_by_hand():
    # B 1, H 1, S 4, D 2, bf16: forward 4·1·1·2·16 = 128 FLOPs, bytes
    # 4 tensors of 8 elements × 2 + lse 16
    f = devtrace.attention_bound_s(1, 1, 4, 2, False, 2, False, 1.0, 1e9)
    assert f == 128.0
    b = devtrace.attention_bound_s(1, 1, 4, 2, False, 2, True, 1e9, 1.0)
    assert b == 8 * 8 * 2 + 16
    # causal pairs S(S+1)/2 = 10
    c = devtrace.attention_bound_s(1, 1, 4, 2, True, 2, False, 1.0, 1e9)
    assert c == 4 * 2 * 10


def test_merged_busy_counts_overlaps_once():
    busy, gaps = devtrace.merged_busy([(0, 2), (1, 3), (5, 6), (5.5, 7)])
    assert busy == 5
    assert gaps == [(3, 2)]


class _Seg(devtrace.Segment):
    def __init__(self, events, t0, t1):
        self.events, self.t0_us, self.t1_us = events, t0, t1


def test_segment_gaps_device_time_and_breakdown():
    seg = _Seg([(10, 20, "flash_fwd_tc"), (30, 50, "sm90_gemm"),
                (60, 70, "flash_bwd_dq_tc")], 0, 100)
    assert seg.busy_s() == pytest.approx(40e-6)
    assert sorted(seg.gaps()) == [(0, 10), (20, 10), (50, 10), (70, 30)]
    assert seg.device_time_s(["flash_"]) == pytest.approx(20e-6)
    assert seg.device_time_s(["flash_"], within=[(0, 25)]) == \
        pytest.approx(10e-6)
    spans = [{"name": "train:step", "start_us": 0, "dur_us": 80},
             {"name": "train:dispatch", "start_us": 5, "dur_us": 60}]
    out = devtrace.breakdown(seg, spans)
    assert out["device_ops"][0] == ["sm90_gemm", pytest.approx(20e-6)]
    assert out["idle_gaps"][0] == ["no span", pytest.approx(30e-6)]
    assert ["train:dispatch", pytest.approx(10e-6)] in out["idle_gaps"]


def test_gradient_error_is_first_order_by_the_worst_leaf():
    """|g - g_ref| over max(|g_ref| of the leaf, of the median leaf), the
    worst leaf of the worst step, whichever side is held."""
    import torch
    from portbench.core import compare
    ref = {1: {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0, 1.0]),
               "c": torch.tensor([6.0, 8.0])}}
    prog = {"a": torch.tensor([3.0, 4.5]), "b": torch.tensor([0.0, 0.0]),
            "c": torch.tensor([6.0, 8.0])}
    for held_is_ref in (True, False):
        held = ref if held_is_ref else {1: prog}
        err = compare.GradientError(dict(held), held_is_ref)
        err(1, prog if held_is_ref else ref[1])
        worst, at = err.worst()
        # a: 0.5 / 5; b: 1 / max(1, median 5) = 0.2; c: 0
        assert worst == pytest.approx(0.2) and at == (1, "b")
