#!/usr/bin/env python3
"""Read a cell's control and faults on the card, at the cell's own size:

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        [--variants fp8,fp8_gemm,half_batch,program,stale_weights]

One JSON line a seed and variant: the cell's numbers (``compare``) for the
variant against the fp32 reference, beside the cell's limits; a
training cell's ``program`` and ``stale_weights`` are whole runs of the
program, sound or with a fault planted, in this one process. The
benchmark's runs never run this; it gives the upper readings that the
limits in ``limits/<cell>.json`` are set below (``core/control.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    from portbench import run
    run.cache_env(ROOT, 0)
    from portbench.core import control, device, spec
    cell = spec.Cell(args.workload)
    dev = device.Device(args.device)
    names = args.variants.split(",") if args.variants \
        else control.variants(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        for v, numbers in control.readings(cell, seed, names, dev).items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "variant": v, "numbers": numbers,
                              "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:] = [ROOT] + [q for q in sys.path
                            if os.path.abspath(q or ".") not in (HERE, ROOT)]
    sys.exit(main())
