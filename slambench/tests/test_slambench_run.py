"""A run prints one well-formed result line, and refuses to run without
its cards or without the program beside the harness."""
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT, tiny

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def test_tiny_cpu_run_gives_a_well_formed_line(manifest):
    from slambench import run
    cell = "forest_os1_solo.dense_scans"
    work = run.load_json(ROOT, "slambench", "workloads", f"{cell}.json")
    line, rows = run.run_cell(manifest, cell, 2 ** 31 + 99, 25.0, False,
                              "cpu", tiny)
    text = json.dumps(line)
    back = json.loads(text)
    assert all(k in back for k in KEYS)
    assert list(back)[-1] == "checks"
    assert set(back["checks"]) == set(work["limits"])
    assert isinstance(back["correct"], bool)
    assert back["attempted"] > 0
    names = {m["name"] for m in manifest["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(back["metrics"]) == names
    for m in back["metrics"].values():
        assert m["value"] > 0
    assert back["device"]["platform"] == "cpu"


def _run(cwd):
    return subprocess.run(
        [sys.executable, "slambench/run.py", "--workload",
         "forest_os1_solo.dense_scans", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=cwd,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_refuses_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "slambench"), tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
