"""A run prints one well-formed result line, judged by its driver's own
judge, and refuses to run without its cards or without the program beside
the harness."""
import json
import os
import shutil
import subprocess
import sys
import types

from conftest import ROOT, tiny

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def test_tiny_cpu_run_gives_a_well_formed_line(manifest, monkeypatch):
    from slambench import judge, run
    from slambench.drivers import solo
    cell = "forest_os1_solo.dense_scans"
    work = run.load_json(ROOT, "slambench", "workloads", f"{cell}.json")
    # the run's judge is the solo driver's; keep what it is handed
    kept = {}

    def program_side(rec):
        kept["capture"] = rec["capture"]
        return judge.program_side(rec)

    def readings(*args):
        kept["args"] = args
        return judge.readings(*args)

    monkeypatch.setattr(solo, "JUDGE", types.SimpleNamespace(
        program_side=program_side, readings=readings))
    line, rows = run.run_cell(manifest, cell, 2 ** 31 + 99, 25.0, False,
                              "cpu", tiny)
    # the same run judged as the harness did before each driver brought
    # its judge: solo's judge called by name, the same rows to the digit
    cfg, work_, traffic, _, device = kept["args"]
    rec = {"capture": kept["capture"], "profiled_dbscan": []}
    values = judge.readings(cfg, work_, traffic, judge.program_side(rec),
                            device)
    assert rows == [(k, values.get(k), lim)
                    for k, lim in work["limits"].items()]
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
    assert back["device"]["count"] == 1


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


STUB_DRIVER = '''"""A stub cell's run: four keyframes and no program."""
from ..judges import stub_judge as JUDGE  # noqa: F401


class Driver:
    def __init__(self, cfg, work, seed, device, trace):
        self.cfg, self.rec, self.traffic = cfg, {}, None

    def setup(self):
        pass

    def sync(self):
        pass

    def window(self, seconds):
        self.rec["gap"] = self.cfg["gap"]
        return 4, [0.1, 0.2, 0.3, 0.4]

    def close(self):
        pass
'''

STUB_JUDGE = '''"""The stub cell's judge."""


def program_side(rec):
    return {"gap": rec["gap"]}


def readings(cfg, work, traffic, side, device):
    return {"stub_gap": side["gap"] * work["scale"], "_uncompared": 1}
'''

STUB_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from slambench import run
m = run.load_json({root!r}, "BENCHMARK.json")
for cell in ("stub.pass", "stub.fail"):
    line, rows = run.run_cell(m, cell, 2 ** 31 + 7, 0.1, False, "cpu")
    print(json.dumps(line))
print("port=%d" % ("slide_slam_tpu_torch" in sys.modules))
"""


def test_a_cell_made_of_new_files_is_judged_by_its_own_judge(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "slambench"), tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "slambench"
    (bench / "drivers" / "stub.py").write_text(STUB_DRIVER)
    (bench / "judges" / "stub_judge.py").write_text(STUB_JUDGE)
    (bench / "configs" / "stub.json").write_text(json.dumps({"gap": 0.25}))
    for name, limit in (("pass", 1.0), ("fail", 0.1)):
        (bench / "workloads" / f"stub.{name}.json").write_text(json.dumps(
            {"driver": "stub", "scale": 2.0,
             "limits": {"stub_gap": limit}}))
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "stub", "source": "a test",
                         "file": "slambench/configs/stub.json",
                         "reduced": [], "why": "a test"})
    m["workloads"] += [{"name": f"stub.{n}", "config": "stub",
                        "traffic": n, "chips": 1, "why": "a test"}
                       for n in ("pass", "fail")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    out = subprocess.run([sys.executable, "-c",
                          STUB_RUN.format(root=str(tmp_path))],
                         capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    *lines, port = out.stdout.strip().splitlines()[-3:]
    ok, bad = (json.loads(x) for x in lines)
    assert ok["checks"] == {"stub_gap": {"value": 0.5, "limit": 1.0}}
    assert ok["correct"] is True and ok["attempted"] == 4
    assert bad["checks"] == {"stub_gap": {"value": 0.5, "limit": 0.1}}
    assert bad["correct"] is False
    assert port == "port=0"
