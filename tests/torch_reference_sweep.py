"""Run the JAX package's own tests against the port and hold the failures
to a triage list.

    python tests/torch_reference_sweep.py [-n WORKERS]

The reference's test files (``tests/test_*.py`` but the port's
``test_torch_*.py`` and the files in ``EXCLUDED``) are copied into a
temporary root together with their support files, beside a ``conftest.py``
that puts a ``sys.meta_path`` finder in front of every import: each
``incubator_mxnet_tpu[.*]`` import gets the module of the same path in
``incubator_mxnet_tpu_torch``. Every thread's default context is ``cpu()``
there. The temporary root links the port and the repository's other top
directories, never the JAX package itself, so a test that starts a Python
process importing the reference fails rather than passes on it. Then
``pytest -m 'not slow' -n WORKERS`` runs them (``JAX_PLATFORMS=cpu``; the
reference's conftest keeps JAX on the CPU and it is copied in).

Every failing test id must stand in ``torch_reference_sweep.json`` with its
category; the script exits 1 on a failure that is not listed and on a
listed test that now passes, and prints the counts. The categories are the
reasons a reference test cannot pass against the port without being a
fault of the port:

- ``jax_or_pallas``: the test calls JAX, Pallas or StableHLO itself;
- ``private_attribute``: it reads or patches a private name of the JAX
  package's internals that the port does not have;
- ``subprocess_imports_reference``: it starts a process or reads a file
  that needs the JAX package or the repository's own path;
- ``needs_cuda``: it needs a device this CPU run does not have;
- ``departure``: the port departs on purpose, and ``roadmap`` quotes the
  ``ROADMAP.md`` section 3 line that documents it.

This file is a tool, not a test: pytest does not collect it (its name does
not start with ``test_``). It takes about two to three minutes on eight
CPU cores.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TRIAGE = os.path.join(HERE, "torch_reference_sweep.json")
CATEGORIES = ("jax_or_pallas", "private_attribute",
              "subprocess_imports_reference", "needs_cuda", "departure")

# reference test files that cannot reach the port at all
EXCLUDED = {
    "test_julia_drift.py": "a language package's sources",
    "test_julia_package.py": "a language package",
    "test_perl_package.py": "a language package",
    "test_r_package.py": "a language package",
    "test_scala_package.py": "a language package",
    "test_lint.py": "the JAX package's own linter",
    "test_lint_project.py": "the JAX package's own linter",
    "test_hlolint.py": "reads StableHLO",
    "test_hlodiff.py": "reads StableHLO",
    "test_cpp_package.py": "builds C++ against the JAX package",
    "test_native_tsan.py": "builds the JAX package's native layer",
    "test_launcher_ssh.py": "launches the JAX package over ssh",
    "test_loadgen.py": "drives the JAX package's serving tools",
    "test_history.py": "the JAX package's history tool",
    "test_large_tensor.py": "the large-tensor tier (skipped unless asked)",
}
SUPPORT = ("conftest.py", "np_cases.py", "dist_worker.py", "fixtures")

CONFTEST_TAIL = '''

# ---- the sweep: every reference import is the port's module -------------
import importlib
import importlib.abc
import importlib.util
import json as _json
import sys as _sys
import threading as _threading

_REF, _PORT = "incubator_mxnet_tpu", "incubator_mxnet_tpu_torch"


class _CpuDefault(_threading.local):
    def __init__(self):
        self.value = _sys.modules[_PORT].cpu()


class _Redirect(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if name == _REF or name.startswith(_REF + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_PORT + spec.name[len(_REF):])
        if spec.name == _REF:
            # imported where the reference would be (a test module), not
            # earlier, so the package's import-time hooks run as late
            module.context.Context._default_ctx = _CpuDefault()
        return module

    def exec_module(self, module):
        # importlib gave the port's module the alias's spec: put its own back
        module.__spec__ = importlib.util.find_spec(module.__name__)


_sys.meta_path.insert(0, _Redirect())

_OUTCOMES = {}


def _failed(report):
    lines = [l for l in str(report.longrepr).splitlines() if l.strip()]
    _OUTCOMES[report.nodeid] = ["failed", lines[-1][:300] if lines else ""]


def pytest_collectreport(report):
    if report.failed:
        _failed(report)


def pytest_runtest_logreport(report):
    if report.failed:
        if _OUTCOMES.get(report.nodeid, [None])[0] != "failed":
            _failed(report)
    elif report.when == "call" or report.skipped:
        _OUTCOMES.setdefault(report.nodeid,
                             ["skipped" if report.skipped else "passed", ""])


def pytest_sessionfinish(session):
    if not hasattr(session.config, "workerinput"):
        with open(os.environ["MXTPU_SWEEP_OUT"], "w") as f:
            _json.dump(_OUTCOMES, f, indent=0, sort_keys=True)
'''


def reference_files():
    return sorted(f for f in os.listdir(HERE)
                  if f.startswith("test_") and f.endswith(".py")
                  and not f.startswith("test_torch_") and f not in EXCLUDED)


def stage(root):
    """The temporary root: tests/ (the reference files, support files and
    the redirecting conftest) and links to the port and the repository's
    other top directories, but the JAX package."""
    tests = os.path.join(root, "tests")
    os.makedirs(tests)
    for name in reference_files() + list(SUPPORT):
        src = os.path.join(HERE, name)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(tests, name))
        elif os.path.exists(src):
            shutil.copy(src, tests)
    with open(os.path.join(tests, "conftest.py"), "a") as f:
        f.write(CONFTEST_TAIL)
    for name in os.listdir(REPO):
        if name not in ("tests", "incubator_mxnet_tpu", ".git"):
            os.symlink(os.path.join(REPO, name), os.path.join(root, name))


def run(workers):
    """{test id: ["passed" | "failed" | "skipped", the failure's last
    line]} of one sweep."""
    root = tempfile.mkdtemp(prefix="mxtpu_sweep_")
    try:
        stage(root)
        out = os.path.join(root, "outcomes.json")
        env = dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu",
                   MXTPU_SWEEP_OUT=out)
        cmd = [sys.executable, "-m", "pytest", "-q", "-m", "not slow",
               "-p", "no:cacheprovider", "-p", "no:randomly",
               "--rootdir", root, "-p", "xdist", "-n", str(workers),
               "--dist", "loadfile"] + \
            [os.path.join("tests", f) for f in reference_files()]
        proc = subprocess.run(cmd, cwd=root, env=env, timeout=3600,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if not os.path.exists(out):
            sys.stdout.write(proc.stdout[-20000:])
            raise SystemExit("the sweep's pytest ended without outcomes "
                             "(exit %d)" % proc.returncode)
        with open(out) as f:
            return json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_triage(triage):
    """The list's own rules: a known category each, and for a departure
    a line that ``ROADMAP.md`` holds."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = " ".join(f.read().split())
    bad = [k for k, v in triage.items()
           if v.get("category") not in CATEGORIES
           or (v["category"] == "departure" and (
               not v.get("roadmap")
               or " ".join(v["roadmap"].split()) not in roadmap))]
    if bad:
        raise SystemExit("triage entries without a valid category: %s"
                         % bad[:10])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", "--workers", type=int, default=6)
    args = ap.parse_args(argv)
    with open(TRIAGE) as f:
        triage = json.load(f)["tests"]
    check_triage(triage)
    outcomes = run(args.workers)
    failed = sorted(k for k, (v, _) in outcomes.items() if v == "failed")
    unlisted = {k: outcomes[k][1] for k in failed if k not in triage}
    passing = sorted(k for k in triage
                     if outcomes.get(k, [None])[0] == "passed")
    missing = sorted(k for k in triage if k not in outcomes)
    counts = {}
    for k in failed:
        cat = triage.get(k, {}).get("category", "unlisted")
        counts[cat] = counts.get(cat, 0) + 1
    summary = {
        "files": len(reference_files()),
        "passed": sum(v == "passed" for v, _ in outcomes.values()),
        "skipped": sum(v == "skipped" for v, _ in outcomes.values()),
        "failed": len(failed), "failed_by_category": counts,
        "unlisted_failures": unlisted, "listed_but_passing": passing,
        "listed_but_not_run": missing}
    print(json.dumps(summary, indent=1))
    return 1 if unlisted or passing or missing else 0


if __name__ == "__main__":
    sys.exit(main())
