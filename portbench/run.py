#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; ``portbench/core/spec.py`` says which files it names. The
run builds the port's program for the cell, warms up every shape the cell
uses (set-up), measures for ``--seconds`` (with ``--trace 1``, then
profiles a short segment under the same load for the per-layer metrics),
frees the program, checks what the timed path produced against the plain
reference, and prints one JSON line as the last line of its standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared with its limit (also the last lines of standard error).

It exits with 2 and prints no result when the card is missing or the cell
needs more cards than there are, and with 3 when, once the window has
closed, ``sys.modules`` holds ``jax``, ``jaxlib``, ``flax`` or the JAX
package. Build and kernel caches stay in ``build/`` inside the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
PORT = "incubator_mxnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "incubator_mxnet_tpu")


def process_age_s():
    """Seconds since this process started (its start time in /proc against
    the machine's uptime), so set-up counts the interpreter's start too."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


START = time.perf_counter() - process_age_s()


def cache_env(root, trace):
    """Every compiler cache at a fixed folder inside the checkout, and
    nothing that would load JAX."""
    base = os.path.join(root, "build", "portbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if trace:
        # the window's spans, all of them (serving emits several a request)
        os.environ["MXTPU_SPANS_BUFFER"] = "4000000"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def import_port(root):
    """The port from this checkout, never another copy on the path."""
    if root not in sys.path:
        sys.path.insert(0, root)
    import importlib
    mod = importlib.import_module(PORT)
    where = os.path.dirname(os.path.abspath(mod.__file__))
    if os.path.dirname(where) != root:
        raise ImportError("%s comes from %s, not from the checkout %s"
                          % (PORT, where, root))
    return mod


def result_line(cell, out, trace, dev):
    """The result's JSON object, ``checks`` last."""
    from portbench.core import compare, devtrace, spec
    setup_s = out["t0"] - START
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    checks, ok = compare.checks(out["numbers"], cell.limits)
    device = {"platform": "gpu" if dev.is_cuda else "cpu",
              "kind": dev.name(), "count": cell.chips if dev.is_cuda else 0,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": bool(ok and out["failed"] == 0),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if trace:
        seg = out["segment"]
        device["busy_s"] = seg.busy_s()
        device["window_s"] = seg.window_s
        line["breakdown"] = devtrace.breakdown(seg, out["trace"].spans)
    line["checks"] = checks
    return line, out["detail"]


def run_cell(workload, seed, seconds, trace, device="cuda", root=ROOT,
             cell=None):
    """One run of ``workload``; returns (the result object, detail). The
    harness's tests call it with ``device="cpu"`` and a small ``cell``."""
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench.core import device as devmod, spec
    from portbench.core import serve, train
    cell = cell if cell is not None else spec.Cell(workload, root=root)
    dev = devmod.Device(device)
    drivers = {"train": train.run, "serve_closed": serve.run,
               "serve_open": serve.run_open}
    out = drivers[cell.traffic["kind"]](cell, seed, seconds, bool(trace),
                                        dev)
    return result_line(cell, out, bool(trace), dev)


def main(argv=None):
    args = parse(argv)
    cache_env(ROOT, args.trace)
    import torch
    from portbench.core import device as devmod, spec
    cell = spec.Cell(args.workload)
    missing = devmod.check_cards(cell.chips)
    if missing:
        print("portbench: no run: %s" % missing, file=sys.stderr)
        return 2
    import_port(ROOT)
    torch.cuda.set_device(0)
    line, detail = run_cell(args.workload, args.seed, args.seconds,
                            args.trace, "cuda", ROOT, cell)
    found = forbidden_modules()
    if found:
        print("portbench: the process loaded %s; no result" % ", ".join(found),
              file=sys.stderr)
        return 3
    print("portbench: detail %s" % json.dumps(detail), file=sys.stderr)
    for name, c in line["checks"].items():
        print("check %s %.6g limit %.6g" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    # run as a script, this folder is first on the path, where its folders
    # (core, metrics, ...) would shadow modules of the same top-level names
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") not in (HERE, ROOT)]
    sys.exit(main())
