"""The PyTorch port stands alone: with `jax`, `flax`, `slide_slam_tpu`,
`sklearn`, `cv2`, `matplotlib` and `yaml` (not dependencies of the port;
the machine with the card has neither of the last two) made unimportable,
`slide_slam_tpu_torch`, every one of its modules (parallel/ and
torch.distributed among them), chip_smoke.py and the indoor team's scene
(indoor_rgbd_team.py) import in a fresh interpreter, and neither a CUDA
kernel nor the native runtime core is built on import."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

GUARD = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "slide_slam_tpu", "sklearn", "cv2",
           "matplotlib", "yaml")
for name in BLOCKED:
    sys.modules[name] = None
import slide_slam_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(slide_slam_tpu_torch.__path__,
                                              "slide_slam_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import indoor_rgbd_team
from slide_slam_tpu_torch import kernels, native
assert not kernels._loaded, kernels._loaded
assert native._lib is None and not native._tried
for m in ("native", "parallel.multirobot", "parallel.distributed_ba",
          "parallel.landmark_sharded", "parallel.multiprocess",
          "place_recognition.clipper_alternates", "viz", "io.rosbag",
          "io.config_yaml", "factorgraph.reference_solver"):
    assert "slide_slam_tpu_torch." + m in mods, m
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in BLOCKED and sys.modules[k] is not None)
assert not bad, bad
print(len(mods))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 65, out.stdout


def test_chip_smoke_refuses_without_a_card():
    """No CUDA here: chip_smoke.py must fail and print no result."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
