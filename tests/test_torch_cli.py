"""The port's command line and log files against the JAX package's
(tests/test_io_cli.py): `gen-logs`, `run --device cpu [--viz]`, `eval` and
`convert-bag`.

Logs written by either package load in the other unchanged; gen-logs
writes the same arrays; `run` writes the same files (trajectories, runtime
analysis, maps, summary.json, with --viz mission.png) with the same summary
(keyframes, landmark counts, closure counts, known TFs) and trajectories
within 1 cm, and prints the same summaries (runtime_summary's times
aside); `eval` prints the same ATE to 4 decimals of a trajectory written
from the truth; `convert-bag` writes the same npz and prints the same
lines. Without matplotlib, `run --viz` raises ImportError naming it, after
the results are written. `world_from_reference_map` builds the JAX
package's world from a map file.
"""
import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest

from slide_slam_tpu import cli as jcli
from slide_slam_tpu.io import logs as jlogs
from slide_slam_tpu_torch import cli as tcli
from slide_slam_tpu_torch.io import logs as tlogs
from slide_slam_tpu_torch.io import synthetic

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GEN = ["--robots", "2", "--keyframes", "12", "--trees", "20", "--poles", "4",
       "--cars", "4", "--extent", "20"]


def _same_log(a, b):
    assert a.robot_id == b.robot_id
    assert len(a.keyframes) == len(b.keyframes)
    for x, y in zip(a.keyframes, b.keyframes):
        for k, v in vars(x).items():
            np.testing.assert_array_equal(np.asarray(getattr(y, k)),
                                          np.asarray(v), err_msg=k)


def test_log_roundtrip_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    world = synthetic.make_forest_world(rng, n_trees=20, n_poles=5, n_cars=5,
                                        extent=20.0)
    traj = synthetic.lawnmower_trajectory(10, extent=15.0, rows=1, step=2.0)
    log = synthetic.make_log(world, traj)
    tlogs.save_log(str(tmp_path / "t.npz"), log)
    jlogs.save_log(str(tmp_path / "j.npz"), log)
    _same_log(log, jlogs.load_log(str(tmp_path / "t.npz")))
    _same_log(log, tlogs.load_log(str(tmp_path / "j.npz")))
    _same_log(log, tlogs.load_log(str(tmp_path / "t.npz")))


def _have_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """gen-logs and `run` (with --viz where matplotlib is installed) through
    both CLIs: {package: (data dir, results dir, printed text)}."""
    root = tmp_path_factory.mktemp("cli")
    out = {}
    viz = ["--viz"] if _have_matplotlib() else []
    for name, cli in (("jax", jcli), ("port", tcli)):
        data, res = str(root / f"{name}_data"), str(root / f"{name}_res")
        cli.main(["gen-logs", "--out", data] + GEN)
        extra = ["--device", "cpu"] if name == "port" else []
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["run", "--logs", os.path.join(data, "robot0.npz"),
                      os.path.join(data, "robot1.npz"), "--results", res]
                     + extra + viz)
        out[name] = (data, res, buf.getvalue())
    return out


def test_gen_logs_writes_the_same_arrays(runs):
    for r in range(2):
        a = np.load(os.path.join(runs["jax"][0], f"robot{r}.npz"))
        b = np.load(os.path.join(runs["port"][0], f"robot{r}.npz"))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_run_writes_the_same_files_and_summary(runs):
    jres, tres = runs["jax"][1], runs["port"][1]
    assert sorted(os.listdir(tres)) == sorted(os.listdir(jres))
    assert "summary.json" in os.listdir(tres)
    with open(os.path.join(jres, "summary.json")) as f:
        js = json.load(f)
    with open(os.path.join(tres, "summary.json")) as f:
        ts = json.load(f)
    assert ts == js
    for r in range(2):
        a = tlogs.load_trajectory_tum(
            os.path.join(jres, f"robot{r}_trajectory.txt"))
        b = tlogs.load_trajectory_tum(
            os.path.join(tres, f"robot{r}_trajectory.txt"))
        np.testing.assert_array_equal(b[:, 0], a[:, 0])
        np.testing.assert_allclose(b[:, 1:4], a[:, 1:4], atol=1e-2)
        with open(os.path.join(tres, f"robot{r}_runtime_analysis.txt")) as f:
            t_keys = [line.split(":")[0] for line in f]
        with open(os.path.join(jres, f"robot{r}_runtime_analysis.txt")) as f:
            j_keys = [line.split(":")[0] for line in f]
        assert t_keys == j_keys
        mt = np.loadtxt(os.path.join(tres, f"robot{r}_map.txt"))
        mj = np.loadtxt(os.path.join(jres, f"robot{r}_map.txt"))
        assert mt.shape == mj.shape


def test_eval_matches_jax(runs, capsys):
    log_path = os.path.join(runs["port"][0], "robot0.npz")
    res = runs["port"][1]
    printed = []
    for cli in (jcli, tcli):
        for align in ([], ["--align"]):
            cli.main(["eval", "--traj",
                      os.path.join(res, "robot0_trajectory.txt"),
                      "--log", log_path] + align)
            printed.append(json.loads(capsys.readouterr().out))
    assert printed[:2] == printed[2:]
    assert printed[0]["n"] == 12


def _summaries(printed):
    """The lines `run` prints after the mission: each robot's summary,
    with --viz the PNG path and each runtime_summary (times masked)."""
    lines = [ln for ln in printed.splitlines()
             if re.match(r"robot \d+: [{k]|wrote .*mission\.png", ln)]
    return [re.sub(r"=\d+\.\dms", "=<t>ms", ln) for ln in lines]


def test_run_viz_writes_png_and_jax_summaries(runs):
    """`run --viz` writes mission.png and prints what the JAX CLI prints:
    the same summary lines, the PNG's path and runtime_summary lines that
    differ only in their measured times."""
    if not _have_matplotlib():
        pytest.skip("matplotlib is not installed: run --viz cannot render")
    j, t = (_summaries(runs[k][2]) for k in ("jax", "port"))
    assert len(t) == 2 + 1 + 2, t
    assert t[2].startswith("wrote ") and t[2].endswith("mission.png")
    assert t[:2] == j[:2] and t[3:] == j[3:]
    png = os.path.join(runs["port"][1], "mission.png")
    assert os.path.getsize(png) > 1000


def test_run_viz_without_matplotlib_raises_after_results(runs, tmp_path,
                                                         monkeypatch):
    """With matplotlib unimportable, `run --viz` writes every result file,
    then raises ImportError naming matplotlib (no silent skip)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    res = str(tmp_path / "res")
    with pytest.raises(ImportError, match="matplotlib"):
        tcli.main(["run", "--logs", os.path.join(runs["port"][0],
                                                 "robot0.npz"),
                   "--results", res, "--device", "cpu", "--viz"])
    assert sorted(os.listdir(res)) == [
        "robot0_map.txt", "robot0_runtime_analysis.txt",
        "robot0_trajectory.txt", "summary.json"]


def test_convert_bag_matches_jax(runs, tmp_path, capsys):
    """A bag of robot 1's gen-logs log: convert-bag through either CLI
    writes the same arrays (true_pose: the odometry, a bag carries no
    truth) and prints the same JSON and the same --list lines."""
    from slide_slam_tpu_torch.io import rosbag
    src = os.path.join(runs["port"][0], "robot1.npz")
    bag = str(tmp_path / "robot1.bag")
    rosbag.robot_log_to_bag(bag, tlogs.load_log(src))
    printed, arrays = [], []
    for name, cli in (("jax", jcli), ("port", tcli)):
        out = str(tmp_path / f"{name}.npz")
        cli.main(["convert-bag", "--bag", bag, "--out", out,
                  "--robot-id", "1"])
        got = json.loads(capsys.readouterr().out)
        assert got.pop("out") == out
        cli.main(["convert-bag", "--bag", bag, "--list"])
        printed.append((got, capsys.readouterr().out))
        arrays.append(np.load(out))
    assert printed[0] == printed[1]
    assert printed[1][0] == {"keyframes": 12, "relative_measurements": 0}
    assert printed[1][1] == ("/robot1/semantic_meas_sync_odom  "
                             "sloam_msgs/SemanticMeasSyncOdom\n")
    a, b = arrays
    want = np.load(src)
    assert sorted(a.files) == sorted(b.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert b[k].dtype == a[k].dtype, k
        np.testing.assert_array_equal(
            b[k], want["odom_pose"] if k == "true_pose" else want[k],
            err_msg=k)


def test_world_from_reference_map(tmp_path):
    """A `label x y z` map written into tmp_path (label 0 trees, two other
    labels box-like): the same world as the JAX package's from the same
    seed, every array bit for bit."""
    from slide_slam_tpu.io import synthetic as jsynthetic
    rng = np.random.default_rng(11)
    rows = np.concatenate([
        np.c_[np.zeros(12), rng.uniform(-20, 20, (12, 2)),
              rng.uniform(-3, -2, 12)],
        np.c_[rng.choice([-1.0, -3.0], 5), rng.uniform(-20, 20, (5, 2)),
              rng.uniform(-3, -2, 5)]])
    path = tmp_path / "robot1Map.txt"
    np.savetxt(path, rows, fmt="%.4f")
    for only_trees in (False, True):
        if only_trees:
            np.savetxt(path, rows[:12], fmt="%.4f")
        a = synthetic.world_from_reference_map(str(path),
                                               np.random.default_rng(2))
        b = jsynthetic.world_from_reference_map(str(path),
                                                np.random.default_rng(2))
        for k, v in vars(b).items():
            got = getattr(a, k)
            assert got.dtype == v.dtype and got.shape == v.shape, k
            np.testing.assert_array_equal(got, v, err_msg=k)
        assert len(a.cyl_root) == 12
        assert len(a.cub_label) == (0 if only_trees else 5)
    assert np.median(rows[:12, 3]) != 0
    assert abs(float(np.median(a.cyl_root[:, 2]))) < 1e-6
