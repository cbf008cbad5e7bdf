"""Find a cell and everything it names, by name, from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in files of its own under ``portbench/``:

- ``configs/<config>.json``: the configuration's sizes as run (the
  ``file`` that ``BENCHMARK.json`` gives it), and ``configs/<config>.py``
  beside it: the builder that makes the net from the port's public API,
  the parameters' names and shapes, the FLOP formulas and the inputs;
- ``reference/<config>.py``: the plain PyTorch reference;
- ``traffic/<traffic>.json``: the mix's parameters, read by the driver
  its ``kind`` names (``core/train.py``, ``core/serve.py``);
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``;
- ``metrics/<metric>.py``: one reader a per-layer metric, or
  ``metrics/<stem>.py`` for the metrics ``<stem>.<kind>`` that share one
  (``mfu.train`` and ``mfu.serve`` read ``metrics/mfu.py``);
- ``kernels/attention/*.json``: the kernel names of each attention
  implementation, which the attention rooflines sum.

A later change adds a configuration, a mix, a cell or a metric by adding
such files and entries; nothing here names one.
"""
from __future__ import annotations

import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _import_file(name, path):
    """The module in ``path`` (a name may hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError("cannot import %s" % path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root=ROOT):
    return _load_json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    limits, model module, reference module and metric entries."""

    def __init__(self, name, bench=None, root=ROOT):
        bench = bench if bench is not None else benchmark(root)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError("no workload %r in BENCHMARK.json (have: %s)"
                           % (name, ", ".join(sorted(cells))))
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _load_json(os.path.join(root,
                                              self.config_entry["file"]))
        self.traffic = traffic(self.entry["traffic"])
        self.limits = limits(name)
        self.model = model_module(self.entry["config"])
        self.reference = reference_module(self.entry["config"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.chips = int(self.entry["chips"])


def traffic(name):
    return _load_json(os.path.join(HERE, "traffic", name + ".json"))


def limits(cell_name):
    return _load_json(os.path.join(HERE, "limits", cell_name + ".json"))


def model_module(config_name):
    return _import_file("portbench_config_" + config_name,
                        os.path.join(HERE, "configs", config_name + ".py"))


def reference_module(config_name):
    return _import_file("portbench_reference_" + config_name,
                        os.path.join(HERE, "reference", config_name + ".py"))


def metric_reader(metric_name):
    """``read(trace) -> number or None`` of one per-layer metric: from
    ``metrics/<name>.py``, else from the reader its stem (the name up to
    its first dot) shares with the other cells' kinds."""
    path = os.path.join(HERE, "metrics", metric_name + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics",
                            metric_name.split(".")[0] + ".py")
    return _import_file("portbench_metric_" + metric_name.replace(".", "_"),
                        path).read


def attention_kernels():
    """{implementation: kernel-name substrings} from every data file under
    ``kernels/attention/``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "kernels", "attention",
                                              "*.json"))):
        data = _load_json(path)
        out[os.path.basename(path)[:-5]] = list(data["kernels"])
    return out
