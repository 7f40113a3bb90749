"""Nothing the benchmark runs loads JAX, flax or the JAX package,
compared by whole top-level module name."""
import subprocess
import sys

from conftest import ROOT

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
from slambench import run, judge, control
from slambench.drivers import solo
from slambench.traffic import make_traffic, raycast, synthetic
from slambench.yardstick import roofline, trace
from slambench.reference import association, cylinders, dbscan, lm
from slambench.reference import merges, slidegraph, slidematch
from slambench.judges import team_decisions
from slambench.drivers import team_capture
import slide_slam_tpu_torch.config, slide_slam_tpu_torch.runtime.node
import slide_slam_tpu_torch.runtime.engine
import slide_slam_tpu_torch.frontend.lidar_pipeline
import slide_slam_tpu_torch.frontend.pipeline
import slide_slam_tpu_torch.frontend.clustering
import slide_slam_tpu_torch.place_recognition.slidegraph
import slide_slam_tpu_torch.place_recognition.slidematch
import json
m = run.load_json({root!r}, "BENCHMARK.json")
for x in m["per_layer"]:
    run.metric_reader(x["name"])
print("found=" + ",".join(run.forbidden_loaded()))
print("port=%d" % ("slide_slam_tpu_torch" in sys.modules))
"""


def test_harness_and_program_load_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    found, port = out.stdout.strip().splitlines()[-2:]
    assert found == "found="
    assert port == "port=1"


def test_names_are_compared_whole():
    from slambench import run
    saved = dict(sys.modules)
    try:
        # a test of this process may have loaded the JAX package itself
        for name in list(sys.modules):
            if name.split(".")[0] in run.FORBIDDEN:
                del sys.modules[name]
        sys.modules["slide_slam_tpu_torch_fake"] = sys
        sys.modules["jaxfoo"] = sys
        assert "slide_slam_tpu" not in run.forbidden_loaded()
        assert "jax" not in run.forbidden_loaded()
        sys.modules["slide_slam_tpu.io"] = sys
        assert "slide_slam_tpu" in run.forbidden_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


JUDGE_PROBE = r"""
import sys
sys.path.insert(0, {root!r})
from slambench.judges import team_decisions
from slambench.reference import merges, slidegraph, slidematch
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}}
                      & {{"jax", "jaxlib", "flax", "slide_slam_tpu",
                          "slide_slam_tpu_torch"}})))
"""


def test_the_team_judge_loads_neither_package():
    """The team judge and its references import neither the program nor
    the JAX package: the program is what they judge."""
    out = subprocess.run([sys.executable, "-c",
                          JUDGE_PROBE.format(root=ROOT)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
