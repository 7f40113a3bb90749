"""The JAX package's CLI on chip_smoke.py's slice:bag_mission pipeline, on
the CPU; or, with --port, the PyTorch port's CLI on the same pipeline.

gen-logs at its defaults for 2 robots x 60 keyframes, each log written as a
SemanticMeasSyncOdom bag by the package's own io.rosbag, `convert-bag` (and
`--list`) on each, `run --intra-lc` on the converted logs in the
synchronous runtime and `eval` of each robot against the gen-logs truth
(chip_smoke.bag_mission). The port's CLI takes `run --sync`; the JAX CLI
has no such flag, so its MultiRobotMission is built with
async_runtime=False here (the async runtime applies closure searches when
a worker happens to finish: two JAX runs of the same logs ended with
different landmark counts). Prints one
JSON line: summary.json, eval's ATE and the overflow counters per robot,
convert-bag seconds per bag, the run's wall and kf/s. chip_smoke.py's
JAX_BAG_SUMMARY and JAX_BAG_ATE_M are set from this output (PERF.md).

    JAX_PLATFORMS=cpu python scripts/jax_bag_mission_reference.py
        [--port [--device cpu]]
"""
import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def _jax_sync_runtime():
    """The JAX CLI's MultiRobotMission, built with async_runtime=False."""
    import functools
    from slide_slam_tpu.runtime import mission
    mission.MultiRobotMission.__init__ = functools.partialmethod(
        mission.MultiRobotMission.__init__, async_runtime=False)


def main(port: bool, device: str):
    package = "slide_slam_tpu_torch" if port else "slide_slam_tpu"
    if not port:
        _jax_sync_runtime()
    root = Path(tempfile.mkdtemp(prefix="bag_mission_"))
    try:
        out = chip_smoke.bag_mission(
            str(root / "m"), ("--sync", "--device", device) if port else (),
            package=package)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["package"] = package + (f" ({device})" if port else " (JAX, CPU)")
    print(json.dumps(out))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", action="store_true",
                    help="run slide_slam_tpu_torch's CLI instead")
    ap.add_argument("--device", default="cpu",
                    help="with --port: the run's --device (default cpu)")
    a = ap.parse_args()
    main(a.port, a.device)
