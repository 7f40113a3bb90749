"""BENCHMARK.json keeps to the names, units and files the harness finds."""
import json
import os
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_use_allowed_characters():
    m = _manifest()
    names = [c["name"] for c in m["configs"]]
    names += [w["name"] for w in m["workloads"]]
    names += [w["config"] for w in m["workloads"]]
    names += [w["traffic"] for w in m["workloads"]]
    names += [k for c in m["configs"] for k in c["reduced"]]
    metrics = m["end_to_end"] + m["per_layer"]
    names += [x["name"] for x in metrics]
    for n in names:
        assert NAME.match(n), n
    for x in metrics:
        assert UNIT.match(x["unit"]), x["unit"]
        assert x["better"] in ("lower", "higher")
    assert len({x["name"] for x in metrics}) == len(metrics)
    assert len({w["name"] for w in m["workloads"]}) == len(m["workloads"])


def test_every_named_file_is_there():
    m = _manifest()
    for c in m["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("slambench/")
    for w in m["workloads"]:
        assert os.path.isfile(os.path.join(
            ROOT, "slambench", "workloads", f"{w['name']}.json"))
    for x in m["per_layer"]:
        assert os.path.isfile(os.path.join(
            ROOT, "slambench", "metrics", f"{x['name']}.py"))


def test_every_cell_reports_what_its_metrics_move():
    m = _manifest()
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: set(x.get("workloads", cells)) for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for x in m["per_layer"]:
        for cell in x.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[x["moves"]], (x["name"], cell)
    for cell in cells:
        assert any(cell in v for k, v in e2e.items() if k != "setup_s")
        assert any(cell in x.get("workloads", cells) for x in m["per_layer"])
