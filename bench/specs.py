"""A cell's files, found by the names in ``BENCHMARK.json``.

``BENCHMARK.json`` names the cell's configuration and traffic; the files
are ``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json`` and
``bench/workloads/<cell>.json`` (the cell's limits for ``correct``), and
each metric is read by ``bench/metrics/<metric>.py``.  A later cell,
configuration, traffic or metric is a new file and a new entry: nothing
here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _file(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} breaks the naming rule")
    return os.path.join(BENCH, kind, f"{name}.json")


def benchmark() -> dict:
    return _load(os.path.join(ROOT, "BENCHMARK.json"))


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell``
    reports."""
    return [m for m in bench[kind] if "workloads" not in m
            or cell in m["workloads"]]


def load_cell(name: str, bench: Optional[dict] = None) -> dict:
    """-> {"name", "entry" (the workloads entry), "config", "traffic",
    "limits", "bench"}."""
    bench = benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json: the cells are "
                       f"{[w['name'] for w in bench['workloads']]}")
    entry = entries[0]
    cell = _load(_file("workloads", name))
    for k in ("config", "traffic", "chips"):
        if cell[k] != entry[k]:
            raise ValueError(f"bench/workloads/{name}.json gives {k} "
                             f"{cell[k]!r}, BENCHMARK.json {entry[k]!r}")
    return {"name": name, "entry": entry,
            "config": _load(_file("configs", entry["config"])),
            "traffic": _load(_file("traffic", entry["traffic"])),
            "limits": cell["limits"], "bench": bench}


def reader(metric: str):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    if not NAME.match(metric):
        raise ValueError(f"metric name {metric!r} breaks the naming rule")
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def roofline(kernel: str):
    """The module ``bench/rooflines/<kernel>.py`` (its ``PATTERNS`` and
    ``cost``)."""
    path = os.path.join(BENCH, "rooflines", f"{kernel}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_roofline_" + kernel, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
