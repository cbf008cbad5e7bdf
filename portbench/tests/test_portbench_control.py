"""The comparison that decides ``correct`` has to fail its control and the
faults a cell can have: at a tiny size on the CPU, the reference in fp8 in
the program's place, and a whole run with the timed path broken
underneath."""
from __future__ import annotations

import pytest

from portbench import run
from portbench.core import control, device, spec

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)
TRAIN = ["bert_large.pretrain_s512", "gpt2_medium.pretrain_s1024"]
SERVE = ["bert_large.squad_s384", "bert_large.squad_s384_server"]


def _fails(numbers, limits):
    return any(not v <= limits[k] for k, v in numbers.items())


def _program_numbers(cell, seed):
    line, _ = run.run_cell(cell.name, seed, 0.3, 0, "cpu", cell=cell)
    return {k: c["value"] for k, c in line["checks"].items()}


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_control_separates_at_a_tiny_size(tiny, name):
    """At a size the CPU holds (the program in fp32 here, so it reads
    near 0), the fp8 reference reads three times the program or more on
    one of the cell's numbers, on each seed; the limits are the card's,
    set from readings at the cell's own size (``test_control_on_the_card``
    holds the control to them there)."""
    cell = tiny(name)
    dev = device.Device("cpu")
    for seed in SEEDS:
        prog = _program_numbers(cell, seed)
        ctl = control.reading(cell, seed, "fp8", dev)
        assert any(ctl[k] >= 3 * prog[k] for k in prog), (seed, prog, ctl)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_reading_fails(tiny, name):
    cell = tiny(name)
    numbers = control.reading(cell, SEEDS[0], "half_batch",
                              device.Device("cpu"))
    assert _fails(numbers, cell.limits), numbers


def _run(cell):
    line, _ = run.run_cell(cell.name, SEEDS[1], 0.3, 0, "cpu", cell=cell)
    return line


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged_fails(tiny, monkeypatch, name):
    from incubator_mxnet_tpu_torch.gluon import Trainer
    monkeypatch.setattr(Trainer, "_update", lambda self, *a, **k: None)
    line = _run(tiny(name))
    assert line["correct"] is False
    assert line["checks"]["update_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_stale_weights_fail(tiny, name):
    """The optimizer writes its fp32 masters but, after step 1, no longer
    casts them into the net's weights: Adam's state reads sound, the
    net's weights do not."""
    cell = tiny(name)
    with control.plant("stale_weights"):
        line = _run(cell)
    assert line["correct"] is False
    assert line["checks"]["update_norm_gap"]["value"] > \
        cell.limits["update_norm_gap"]


@pytest.mark.parametrize("name", TRAIN)
def test_program_and_plant_readings(tiny, name):
    """``control.py``'s program variants: a sound run within the limits,
    the planted one over them."""
    cell = tiny(name)
    got = control.readings(cell, SEEDS[2], ["program", "stale_weights"],
                           device.Device("cpu"))
    assert not _fails(got["program"], cell.limits), got
    assert _fails(got["stale_weights"], cell.limits), got


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out_fails(tiny, monkeypatch, name):
    from incubator_mxnet_tpu_torch import jit
    prepare = jit.TrainStep._prepare

    def halved(self, inputs, n_net_inputs):
        args = prepare(self, inputs, n_net_inputs)
        return [a[:a.shape[0] // 2] for a in args]
    monkeypatch.setattr(jit.TrainStep, "_prepare", halved)
    assert _run(tiny(name))["correct"] is False


@pytest.mark.parametrize("alter", ["start_end_swapped", "rows_rolled"])
@pytest.mark.parametrize("name", SERVE)
def test_altered_answer_fails(tiny, monkeypatch, name, alter):
    from incubator_mxnet_tpu_torch.serving import registry
    predict = registry.BlockServable.predict_batch

    def altered(self, *stacked, replica=0):
        outs = [o.copy() for o in predict(self, *stacked, replica=replica)]
        if alter == "start_end_swapped":
            outs[0] = outs[0][..., ::-1].copy()
        else:
            outs[0] = outs[0][::-1].copy()
        return tuple(outs)
    monkeypatch.setattr(registry.BlockServable, "predict_batch", altered)
    cell = tiny(name)
    if alter == "rows_rolled":
        # batches of more than one row
        cell.traffic.update(clients=8, rate_per_s=400)
    assert _run(cell)["correct"] is False


def test_every_cell_has_its_control():
    for w in spec.benchmark()["workloads"]:
        cell = spec.Cell(w["name"])
        assert control.control_of(cell) in control.variants(cell)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN + SERVE[:1])
def test_control_on_the_card(card, name):
    """The control at the cell's own size fails the cell's limits (the
    serving cells share the model, the sample's size and the limit)."""
    cell = spec.Cell(name)
    numbers = control.reading(cell, SEEDS[0], control.control_of(cell),
                              device.Device("cuda"))
    assert _fails(numbers, cell.limits), numbers
