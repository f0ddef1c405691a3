"""The harness finds every configuration, traffic mix, family and metric of
BENCHMARK.json by its name, and refuses a name it does not hold."""

import re

import pytest

from portbench import catalog

BENCH = catalog.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = catalog.cell(BENCH, cell)
    assert c.chips == 1
    assert callable(catalog.family(c.config["family"]).problem)
    assert {"instances", "warmup_max_iter", "whole_solve"} <= set(c.traffic)
    for kind in ("end_to_end", "per_layer"):
        names = [m["name"] for m in catalog.metrics(BENCH, cell, kind)]
        assert names
        for name in names:
            assert callable(catalog.reader(name))


@pytest.mark.parametrize("kind,name", [
    ("cell", "maxcut_d8.nonesuch"), ("cell", "../maxcut_d8"), ("metric", "nonesuch_pct"),
    ("metric", "a/b"), ("family", "graphm_nonesuch")])
def test_unknown_names_are_refused(kind, name):
    with pytest.raises(catalog.UnknownName):
        if kind == "cell":
            catalog.cell(BENCH, name)
        elif kind == "metric":
            catalog.reader(name)
        else:
            catalog.family(name)


def test_benchmark_file_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        cfg = catalog._json("configs", c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
