"""Finds what a run needs by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration,
``portbench/configs/<config>.json``, and a traffic mix,
``portbench/traffic/<traffic>.json``.  A configuration names its family,
``portbench/families/<family>.py``: the generator of its instances.  Each
metric has a reader, ``portbench/metrics/<metric>.py``.  A later cell,
configuration, family or metric is a new file and a new entry; no file
here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import List

__all__ = ["HERE", "ROOT", "UnknownName", "Cell", "benchmark", "cell", "metrics", "reader",
           "family"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


class UnknownName(LookupError):
    """A name that ``BENCHMARK.json`` or the benchmark's folders do not
    hold."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict


def _checked(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise UnknownName(f"{name!r} is not a name")
    return name


def _json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, _checked(name) + ".json")
    if not os.path.isfile(path):
        raise UnknownName(f"no {kind} file {os.path.relpath(path, ROOT)}")
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(bench: dict, name: str) -> Cell:
    """The cell ``name`` with its configuration and traffic files."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return Cell(name, int(w["chips"]), _json("configs", w["config"]),
                        _json("traffic", w["traffic"]))
    raise UnknownName(f"no cell {name!r} in BENCHMARK.json")


def metrics(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The entries of ``kind`` ("end_to_end" or "per_layer") that the cell
    reports."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def _module(kind: str, name: str):
    path = os.path.join(HERE, kind, _checked(name) + ".py")
    if not os.path.isfile(path):
        raise UnknownName(f"no {kind} file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The function ``read(run) -> float or None`` of metric ``metric``."""
    return _module("metrics", metric).read


def family(name: str):
    """The module of family ``name``: its ``problem(config, seed)``."""
    return _module("families", name)
