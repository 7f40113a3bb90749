"""The port's command line and log files against the JAX package's
(tests/test_io_cli.py): `gen-logs`, `run --device cpu` and `eval`.

Logs written by either package load in the other unchanged; gen-logs
writes the same arrays; `run` writes the same files (trajectories, runtime
analysis, maps, summary.json) with the same summary (keyframes, landmark
counts, closure counts, known TFs) and trajectories within 1 cm; `eval`
prints the same ATE to 4 decimals of a trajectory written from the truth.
`--viz` and `convert-bag` are not ported and raise.
"""
import json
import os

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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        data, res = str(root / f"{name}_data"), str(root / f"{name}_res")
        cli.main(["gen-logs", "--out", data] + GEN)
        extra = ["--device", "cpu"] if name == "port" else []
        cli.main(["run", "--logs", os.path.join(data, "robot0.npz"),
                  os.path.join(data, "robot1.npz"), "--results", res]
                 + extra)
        out[name] = (data, res)
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


def test_unported_commands_raise(runs, tmp_path):
    data = runs["port"][0]
    with pytest.raises(NotImplementedError, match="viz"):
        tcli.main(["run", "--logs", os.path.join(data, "robot0.npz"),
                   "--results", str(tmp_path), "--device", "cpu", "--viz"])
    with pytest.raises(NotImplementedError, match="convert-bag"):
        tcli.main(["convert-bag", "--bag", str(tmp_path / "x.bag")])
