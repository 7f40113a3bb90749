"""The comparison that decides `correct` fails the control (the plain
reference in the program's place at TF32) and every fault a solo cell can
have, planted in the timed path, at a CPU test's size."""
import pytest
import torch

from conftest import ROOT, tiny

DENSE, OBJECTS = "forest_os1_solo.dense_scans", "forest_os1_solo.object_stream"


def _cell(cell):
    from slambench import run
    m = run.load_json(ROOT, "BENCHMARK.json")
    _, conf = run.cell_of(m, cell)
    cfg = run.load_json(ROOT, conf["file"])
    work = run.load_json(ROOT, "slambench", "workloads", f"{cell}.json")
    tiny(cfg, work)
    return cfg, work


@pytest.mark.parametrize("cell", (DENSE, OBJECTS))
def test_control_fails_and_program_passes(cell):
    from slambench import judge
    from slambench.drivers import solo
    from slambench.run import verdict
    from slambench.reference import precision
    cfg, work = _cell(cell)
    drv = solo.Driver(cfg, work, 11, "cpu", False)
    drv.setup()
    try:
        drv.window(25.0)
    finally:
        drv.close()
    prog = judge.program_side(drv.rec)
    ok, rows = verdict(judge.readings(cfg, work, drv.traffic, prog, "cpu"),
                       work["limits"])
    assert ok, rows
    side = judge.control_side(cfg, work, drv.traffic, prog, precision.tf32,
                              "cpu")
    ok, rows = verdict(judge.readings(cfg, work, drv.traffic, side, "cpu"),
                       work["limits"])
    assert not ok, rows


def _unchanged_state(step):
    def fault(cfg, state, *a, **k):
        _, out = step(cfg, state, *a, **k)
        return state, out
    return fault


def _label_altered(cluster):
    def fault(points, valid, params):
        labels = cluster(points, valid, params).clone()
        labels[:, 0] = 12345
        return labels
    return fault


def _half_left_out(cluster):
    def fault(points, valid, params):
        half = valid.clone()
        half[:, 1::2] = False
        return cluster(points, half, params)
    return fault


def _solve_skipped(solve_full):
    def fault(cfg, state):
        return state
    return fault


def _match_altered(step):
    def fault(*a, **k):
        state, out = step(*a, **k)
        m = out.cyl_matches
        return state, out._replace(cyl_matches=torch.where(m >= 0, m + 1,
                                                           m))
    return fault


FAULTS = [(DENSE, "engine", "keyframe_step_fused", _unchanged_state),
          (DENSE, "clustering", "two_stage_cluster_batch", _label_altered),
          (DENSE, "clustering", "two_stage_cluster_batch", _half_left_out),
          (DENSE, "engine", "solve_full", _solve_skipped),
          (OBJECTS, "engine", "keyframe_step_fused", _unchanged_state),
          (OBJECTS, "engine", "keyframe_step_fused", _match_altered),
          (OBJECTS, "engine", "solve_full", _solve_skipped)]


@pytest.mark.parametrize("cell,module,name,make", FAULTS,
                         ids=[f"{c.split('.')[1]}-{m.__name__.strip('_')}"
                              for c, _, _, m in FAULTS])
def test_a_planted_fault_reads_not_correct(cell, module, name, make,
                                           monkeypatch, manifest):
    from slambench import run
    from slide_slam_tpu_torch.frontend import clustering
    from slide_slam_tpu_torch.runtime import engine
    mod = {"engine": engine, "clustering": clustering}[module]
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    line, rows = run.run_cell(manifest, cell, 5, 25.0, False, "cpu", tiny)
    assert line["correct"] is False, rows
