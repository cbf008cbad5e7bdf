"""Tests of the port's benchmark harness on the CPU, at tiny sizes.

Card-only tests carry the ``cuda`` marker and decide inside the test
whether a card is there. Run them on the card with

    python3 -m pytest -m cuda portbench/tests -q
"""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


def tiny_cell(name):
    """The cell ``name`` of BENCHMARK.json at a size the CPU holds: widths
    and depth cut, fp32, short mixes. Its limits are the cell's own."""
    from portbench.core import spec
    cell = spec.Cell(name)
    cfg, tr = cell.config, cell.traffic
    if "num_hidden_layers" in cfg:
        cfg.update(vocab_size=211, hidden_size=128, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=256,
                   max_position_embeddings=64)
    else:
        cfg.update(vocab_size=197, n_embd=128, n_layer=2, n_head=2,
                   n_positions=64)
        cfg["run"]["hidden_size"] = 256
    cfg["run"]["dtype"] = "float32"
    if tr["kind"] == "train":
        tr.update(batch=4, seq_len=32, distinct_batches=4,
                  reference_rows_per_block=2, profiled_steps=2)
    elif tr["kind"] == "serve_closed":
        tr.update(seq_len=32, clients=4, max_batch_size=4,
                  distinct_requests=64, warm_s=0.2, profiled_s=0.2,
                  checked_replies=16, reference_rows_per_block=4)
    else:
        tr.update(seq_len=32, rate_per_s=60, gap_pool=64, max_batch_size=4,
                  distinct_requests=64, warm_s=0.2, profiled_s=0.2,
                  checked_replies=16, reference_rows_per_block=4)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture
def card():
    """Skips unless an NVIDIA card is visible (decided at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
