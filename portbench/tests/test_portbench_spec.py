"""BENCHMARK.json and the files it names: found by name, complete, and
within the benchmark contract's limits."""
from __future__ import annotations

import json
import os
import re

import pytest

from portbench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    size = os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json"))
    assert size <= 64 * 1024


def test_names_units_and_entry_keys(bench):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}
    for key, keys in allowed.items():
        names = [e["name"] for e in bench[key]]
        assert len(names) == len(set(names))
        for e in bench[key]:
            assert set(e) <= keys, (key, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = spec.Cell(w["name"], bench)
        assert cell.chips == 1
        assert cell.traffic["kind"] in ("train", "serve_closed",
                                        "serve_open")
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
        assert hasattr(cell.model, "param_specs")
        assert hasattr(cell.reference, cell.traffic["task"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_configs_hold_the_published_sizes(bench):
    published = {
        "bert_large": {"vocab_size": 30522, "hidden_size": 1024,
                       "num_hidden_layers": 24, "num_attention_heads": 16,
                       "intermediate_size": 4096,
                       "max_position_embeddings": 512},
        "gpt2_medium": {"vocab_size": 50257, "n_embd": 1024, "n_layer": 24,
                        "n_head": 16, "n_positions": 1024}}
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/configs/")
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        # what was changed from the source is listed, with the published
        # value beside it, and is never a width
        assert sorted(cfg["published"]) == sorted(c["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k) and cfg[k] != cfg["published"][k]
            assert k not in published[c["name"]], k
            assert not re.search(r"(_dim|_rank|_size$|^n_inner$)", k), k
        for k, v in published[c["name"]].items():
            assert cfg[k] == v, (c["name"], k)
        assert cfg["assumed"]


def test_every_metric_has_a_reader_and_valid_moves(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(moved), m["name"]


def test_traffic_and_attention_kernels_by_name():
    assert spec.traffic("pretrain_s512")["batch"] == 64
    assert spec.traffic("squad_s384")["seq_len"] == 384
    kernels = spec.attention_kernels()
    assert "flash_fwd" in kernels["flash"]
    with pytest.raises(KeyError):
        spec.Cell("no_such.cell")


def test_a_full_check_fits_its_time(bench):
    """2 + 14 runs a cell, each run_seconds + 60 s, 2 × 90 s a cell to
    compile and 1200 s spare, with the full 24 cells, within 43200 s."""
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
