"""Every cell's traffic is the same for a seed and differs across seeds;
dense scans keep every class point and stay within the configuration's
per-class capacity (at most 65536)."""
import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny

CELLS = ("forest_os1_solo.dense_scans", "forest_os1_solo.object_stream")


def _load(cell):
    from slambench import run
    m = run.load_json(ROOT, "BENCHMARK.json")
    _, conf = run.cell_of(m, cell)
    cfg = run.load_json(ROOT, conf["file"])
    work = run.load_json(ROOT, "slambench", "workloads", f"{cell}.json")
    return cfg, work


def _digest(t):
    parts = [t.odom, t.traj, t.world.cyl_root]
    if t.scans is not None:
        parts += [s.points for s in t.scans] + [s.labels for s in t.scans]
    else:
        parts += [o["cyl_root"] for o in t.obs]
    return [np.asarray(p) for p in parts]


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_repeats_for_a_seed_and_differs_across_seeds(cell):
    from slambench.traffic import make_traffic
    cfg, work = _load(cell)
    tiny(cfg, work)
    seed = 2 ** 31 + 12345
    a = _digest(make_traffic(cfg, work["traffic"], seed, "cpu"))
    b = _digest(make_traffic(cfg, work["traffic"], seed, "cpu"))
    c = _digest(make_traffic(cfg, work["traffic"], seed + 1, "cpu"))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(x.shape == y.shape and np.array_equal(x, y)
                   for x, y in zip(a, c))


def test_dense_scans_keep_every_class_point():
    from slambench.traffic import make_traffic
    cfg, work = _load("forest_os1_solo.dense_scans")
    assert cfg["pipeline"]["max_points_per_class"] <= 65536
    tiny(cfg, work)
    t = make_traffic(cfg, work["traffic"], 7, "cpu")
    cap = cfg["pipeline"]["max_points_per_class"]
    assert 0 < t.class_max.max() <= cap
    cfg["pipeline"]["max_points_per_class"] = int(t.class_max.max()) - 1
    with pytest.raises(ValueError):
        make_traffic(cfg, work["traffic"], 7, "cpu")


def test_each_returned_point_lies_on_its_own_pixel():
    from slambench.traffic import make_traffic
    from slide_slam_tpu_torch.frontend import range_projection
    cfg, work = _load("forest_os1_solo.dense_scans")
    tiny(cfg, work)
    t = make_traffic(cfg, work["traffic"], 3, "cpu")
    s = cfg["sensor"]
    for scan in t.scans[:5]:
        pts = torch.as_tensor(scan.points)
        ri = range_projection.project(
            pts, torch.zeros(len(pts)), torch.ones(len(pts), dtype=bool),
            height=s["rows"], width=s["cols"], fov_up_deg=s["fov_up_deg"],
            fov_down_deg=s["fov_down_deg"])
        pix = (ri.proj_y.long() * s["cols"] + ri.proj_x.long()).numpy()
        assert np.array_equal(pix, scan.beam)
        img = scan.label_image[0].reshape(-1).numpy()
        assert np.array_equal(img[scan.beam], scan.labels)


@pytest.mark.cuda
def test_full_size_scans_fit_the_class_capacity_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the full-size scans are cast there")
    from slambench.traffic import make_traffic
    cfg, work = _load("forest_os1_solo.dense_scans")
    for seed in (0, 1, 2, 2 ** 31 + 7):
        t = make_traffic(cfg, work["traffic"], seed, "cuda")
        assert t.class_max.max() <= cfg["pipeline"]["max_points_per_class"]
