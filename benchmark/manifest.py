"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The harness reads:

- the configuration's ``file`` (``configs/<name>.json``), whose ``driver``
  names ``drivers/<driver>.py`` and whose ``check`` names
  ``checks/<check>.py``;
- the traffic mix ``workloads/<traffic>.json``;
- the limits of the cell's correctness check, ``limits/<cell>.json``;
- each per-layer metric's reader, ``layer_metrics/<metric>.py``.

Adding a configuration, a traffic mix, a cell or a per-layer metric adds
files and entries, and so does a new kind of configuration (a driver, a
check and its reference); no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    per_layer: list
    end_to_end: list


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load(root: str) -> dict:
    """The manifest at the root of a checkout."""
    return _json(os.path.join(root, "BENCHMARK.json"))


def reports(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: named in its
    ``workloads``, or every cell where it has none."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: str, name: str, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest at ``root`` with its files read."""
    m = manifest or load(root)
    (wl,) = [w for w in m["workloads"] if w["name"] == name] or [None]
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    (cfg,) = [c for c in m["configs"] if c["name"] == wl["config"]]
    bench = os.path.join(root, "benchmark")
    return Cell(name, wl, _json(os.path.join(root, cfg["file"])),
                _json(os.path.join(bench, "workloads", f"{wl['traffic']}.json")),
                _json(os.path.join(bench, "limits", f"{name}.json")),
                [p for p in m["per_layer"] if reports(p, name)],
                [e for e in m["end_to_end"] if reports(e, name)])


def module(path: str, name: str):
    """The Python file ``path`` loaded as the module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(root: str, config: dict):
    """The driver module that the configuration names."""
    from . import drivers  # noqa: F401  (the package its files import from)

    kind = config["driver"]
    return module(os.path.join(root, "benchmark", "drivers", f"{kind}.py"),
                  f"benchmark.drivers.{kind}")


def check(root: str, config: dict):
    """The check module that the configuration names (``check.py`` says
    what it exports)."""
    from . import checks  # noqa: F401  (the package its files import from)

    kind = config["check"]
    return module(os.path.join(root, "benchmark", "checks", f"{kind}.py"),
                  f"benchmark.checks.{kind}")


def reader(root: str, metric: str):
    """The ``read(ctx)`` of the per-layer metric ``metric``."""
    path = os.path.join(root, "benchmark", "layer_metrics", f"{metric}.py")
    return module(path, f"benchmark_layer_metric_{re.sub(r'[^A-Za-z0-9_]', '_', metric)}").read
