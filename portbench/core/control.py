"""The readings that limits are set between: the reference put in the
program's place in a lower precision (the control) and planted faults,
each compared with the fp32 reference by the cell's own numbers.

Training cells (no window needed): the fp32 reference follows the checked
steps once; then, from the same weights and batches,

- ``fp8``: the control, the reference computed in float8 e4m3, the
  precision below the configuration's bfloat16 (``plain.Arith``);
- ``fp8_gemm``: the reference with only its matrix products' operands in
  fp8, read for the record;
- ``half_batch``: the fp32 reference on the first half of each batch's
  rows, the mean taken over them (a step that leaves out half the batch);
- ``program``: the program itself, a whole run with a short window, the
  sound readings the limits are set above;
- ``stale_weights``: the program with a fault planted under it: after its
  first call (on the card, the eager step; the capture is the second),
  the optimizer's update writes the fp32 masters but no longer casts
  them into the net's bf16 weights, so the replayed steps leave the
  weights where step 1 put them (``plant``).

A step that leaves its state unchanged needs no run: its change and its
gradient (m stays zero) are 0, a gap of 1 by ``compare.training``.

Serving cells: a sample of ``checked_replies`` requests drawn from the
seed, as a run draws its sample, through the fp32 reference and

- ``int8_program``: the port's own int8 path switched on, the control
  where the program has one: the served block with the seed's weights
  through ``contrib.quantization.quantize_net`` (every Dense int8,
  calibrated on the pool's first batch), its forward on the sample;
- ``fp8``, ``fp8_gemm``: the reference in float8 e4m3, as above;
- ``misrouted``: the fp32 reference's replies handed to the wrong
  requests (rolled by one), an answer altered where the batcher delivers
  it.
"""
from __future__ import annotations

import contextlib

import torch

from portbench.core import compare, weights
from portbench.reference import plain

TRAIN_VARIANTS = ("fp8", "fp8_gemm", "half_batch", "program",
                  "stale_weights")
PROGRAM_VARIANTS = ("program", "stale_weights")
PROGRAM_SECONDS = 1.0
SERVE_VARIANTS = ("int8_program", "fp8", "fp8_gemm", "misrouted")


@contextlib.contextmanager
def plant(fault):
    """The program with ``fault`` under it while the block runs
    (``"stale_weights"``: the optimizer's cast of the masters into the
    net's weights skipped from its second call on: the update writes into
    copies of the weights)."""
    if fault is None:
        yield
        return
    if fault != "stale_weights":
        raise ValueError("unknown fault %r" % fault)
    from incubator_mxnet_tpu_torch.optimizer import optimizer as opt_mod
    update_all = opt_mod.Optimizer.update_all
    calls = []

    def stale(self, weights_, grads, states, *args, **kwargs):
        calls.append(1)
        if len(calls) > 1:
            weights_ = [w.clone() for w in weights_]
        return update_all(self, weights_, grads, states, *args, **kwargs)
    opt_mod.Optimizer.update_all = stale
    try:
        yield
    finally:
        opt_mod.Optimizer.update_all = update_all


def _program_reading(cell, seed, variant, dev):
    from portbench import run
    with plant(None if variant == "program" else variant):
        line, _ = run.run_cell(cell.name, seed, PROGRAM_SECONDS, 0,
                               "cuda" if dev.is_cuda else "cpu", cell=cell)
    return {k: c["value"] for k, c in line["checks"].items()}


def _train_readings(cell, seed, names, dev):
    cfg, tr, model = cell.config, cell.traffic, cell.model
    task, opt = tr["task"], tr["optimizer_params"]
    specs = model.param_specs(cfg, task)
    dtype = model.dtype(cfg)
    out = {v: _program_reading(cell, seed, v, dev)
           for v in names if v in PROGRAM_VARIANTS}
    names = [v for v in names if v not in PROGRAM_VARIANTS]
    if not names:
        return out
    gen = weights.generator(seed, dev.torch, 1)
    batches = [model.make_batch(cfg, tr, gen, dev.torch)
               for _ in range(tr["checked_steps"])]
    fn = getattr(cell.reference, task)
    rpb = tr["reference_rows_per_block"]
    plain.highest_precision()

    def follow(precision, rows, on_grad):
        out = plain.train(weights.widened(specs, seed, dev.torch, dtype),
                          rows, fn(cfg, precision), opt, rpb,
                          served_dtype=dtype, on_grad=on_grad)
        dev.release()
        return out
    hook, held = compare.keep_gradients()
    ref = follow("fp32", batches, hook)
    for v in names:
        error = compare.GradientError(dict(held), held_is_reference=True)
        if v in ("fp8", "fp8_gemm"):
            other = follow(v, batches, error)
        elif v == "half_batch":
            other = follow("fp32", [tuple(x[:x.shape[0] // 2] for x in b)
                                    for b in batches], error)
        else:
            raise ValueError("unknown training variant %r" % v)
        out[v], _ = compare.training(other, ref, error)
    return out


def _serve_readings(cell, seed, names, dev):
    cfg, tr, model = cell.config, cell.traffic, cell.model
    task = tr["task"]
    specs = model.param_specs(cfg, task)
    dtype = model.dtype(cfg)
    gen = weights.generator(seed, dev.torch, 1)
    ids, types = model.make_requests(cfg, tr, gen, dev.torch)
    g = weights.generator(seed, torch.device("cpu"), 2)
    rows = torch.randperm(ids.shape[0], generator=g)[:tr["checked_replies"]]
    inputs = [ids[rows.to(ids.device)], types[rows.to(ids.device)]]
    plain.highest_precision()
    w = weights.widened(specs, seed, dev.torch, dtype)
    fn = getattr(cell.reference, task)
    rpb = tr["reference_rows_per_block"]

    def outputs(precision):
        f = fn(cfg, precision)
        return plain.forward_blocks(lambda a, b: f(w, a, b), inputs,
                                    rpb).float().cpu()
    want = outputs("fp32")
    out = {}
    for v in names:
        if v == "int8_program":
            got = _int8_program(cell, seed, dev, ids, inputs)
        elif v in ("fp8", "fp8_gemm"):
            got = outputs(v)
        elif v == "misrouted":
            got = want.roll(1, dims=0)
        else:
            raise ValueError("unknown serving variant %r" % v)
        out[v], _ = compare.serving(got, want,
                                    w[model.readout(task)].cpu())
    del w
    dev.release()
    return out


def _int8_program(cell, seed, dev, ids, inputs):
    """The served block's outputs on ``inputs`` with the port's int8 path
    on (``quantize_net``), the seed's weights loaded first."""
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.contrib import quantization
    from incubator_mxnet_tpu_torch.torch import to_torch
    cfg, tr, model = cell.config, cell.traffic, cell.model
    net = model.build(mxt, cfg, tr["task"], dev.ctx(mxt))
    weights.load_into(net, weights.make(model.param_specs(cfg, tr["task"]),
                                        seed, dev.torch, model.dtype(cfg)))
    batch = tr["max_batch_size"]
    quantization.quantize_net(net, calib_data=[(ids[:batch],)],
                              num_calib_batches=1)
    out = plain.forward_blocks(lambda a, b: to_torch(net(a, b)), inputs,
                               tr["reference_rows_per_block"])
    del net
    dev.release()
    return out.float().cpu()


def readings(cell, seed, names, dev):
    """{variant: the cell's numbers for it against the fp32 reference}."""
    if cell.traffic["kind"] == "train":
        return _train_readings(cell, seed, names, dev)
    return _serve_readings(cell, seed, names, dev)


def reading(cell, seed, variant, dev):
    return readings(cell, seed, [variant], dev)[variant]


def control_of(cell):
    """The variant that is the cell's control: the program's own int8 path
    where it has one (serving), else the reference in fp8."""
    return "fp8" if cell.traffic["kind"] == "train" else "int8_program"


def variants(cell):
    return TRAIN_VARIANTS if cell.traffic["kind"] == "train" \
        else SERVE_VARIANTS
