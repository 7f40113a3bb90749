"""The team cell's files load no JAX, flax or JAX package; its judge, its
references and its traffic load neither the JAX package nor the program,
which is what they judge; its metric readers load."""
import subprocess
import sys

from conftest import ROOT

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
from slambench import run
from slambench.drivers import team
import slide_slam_tpu_torch.runtime.mission
m = run.load_json({root!r}, "BENCHMARK.json")
cell = "forest_team3.demo"
names = [x["name"] for x in m["per_layer"] if cell in x.get("workloads", [])]
for name in names:
    run.metric_reader(name)
print("metrics=%d" % len(names))
print("found=" + ",".join(run.forbidden_loaded()))
"""

JUDGE_PROBE = r"""
import sys
sys.path.insert(0, {root!r})
from slambench.judges import team
from slambench.traffic import team as traffic
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}}
                      & {{"jax", "jaxlib", "flax", "slide_slam_tpu",
                          "slide_slam_tpu_torch"}})))
"""


def _probe(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()


def test_the_team_cell_and_its_readers_load_no_jax():
    metrics, found = _probe(PROBE)[-2:]
    assert metrics == "metrics=5"
    assert found == "found="


def test_the_team_judge_and_traffic_load_neither_package():
    assert _probe(JUDGE_PROBE) == []
