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
import slide_slam_tpu_torch.config, slide_slam_tpu_torch.runtime.node
import slide_slam_tpu_torch.runtime.engine
import slide_slam_tpu_torch.frontend.lidar_pipeline
import slide_slam_tpu_torch.frontend.pipeline
import slide_slam_tpu_torch.frontend.clustering
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
        sys.modules["slide_slam_tpu_torch_fake"] = sys
        sys.modules["jaxfoo"] = sys
        assert "slide_slam_tpu" not in run.forbidden_loaded()
        assert "jax" not in run.forbidden_loaded()
        sys.modules["slide_slam_tpu.io"] = sys
        assert "slide_slam_tpu" in run.forbidden_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
