"""The PyTorch port stands alone: with `jax`, `flax`, `slide_slam_tpu`,
`sklearn` and `cv2` (not dependencies of the port) made unimportable,
`slide_slam_tpu_torch`, every one of its modules, chip_smoke.py and the
indoor team's scene (indoor_rgbd_team.py) import in a fresh interpreter,
and no CUDA kernel is built on import."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

GUARD = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "slide_slam_tpu", "sklearn", "cv2"):
    sys.modules[name] = None
import slide_slam_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(slide_slam_tpu_torch.__path__,
                                              "slide_slam_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import indoor_rgbd_team
from slide_slam_tpu_torch import kernels
assert not kernels._loaded, kernels._loaded
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "slide_slam_tpu",
                                    "sklearn", "cv2")
             and sys.modules[k] is not None)
assert not bad, bad
print(len(mods))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 53, out.stdout


def test_chip_smoke_refuses_without_a_card():
    """No CUDA here: chip_smoke.py must fail and print no result."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
