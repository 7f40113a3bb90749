"""A traced run reads the program's own spans: PCG iterations, PCG time and
host reads a keyframe; each keyframe's and scan's root span lies inside the
solo loop's mark once put on the trace's clock; and there is no PCG idle
share where the trace has no kernels (the CPU)."""
import math

from conftest import tiny

NEW = ("solver.pcg_iters_per_kf", "solver.pcg_ms_p50",
       "step.host_syncs_per_kf")


def test_traced_cpu_run_reads_the_program_spans(manifest, monkeypatch):
    from slambench import run
    from slambench.yardstick import program_spans as ps
    from slambench.yardstick import trace as tr
    from slide_slam_tpu_torch.runtime import profiling
    reduced = []
    reduce = tr.reduce
    monkeypatch.setattr(tr, "reduce",
                        lambda prof: reduced.append(reduce(prof)) or
                        reduced[-1])
    profiling.reset()
    def early(cfg, work):
        # the profiled keyframes from the second on, so that a loaded
        # CPU still reaches all three inside the window
        tiny(cfg, work)
        work["trace"]["keyframes"] = [1, 3]
    line, _ = run.run_cell(manifest, "forest_os1_solo.dense_scans",
                           2 ** 31 + 7, 20.0, True, "cpu", early)
    got = line["metrics"]
    for name in NEW:
        assert name in got, name
        assert math.isfinite(got[name]["value"]) and got[name]["value"] > 0
    assert "solver.pcg_idle_pct" not in got

    spans = ps.program_spans()
    rec = {"trace": reduced[0]}
    off, err, pairs = ps.alignment(rec, spans)
    assert len(pairs) == 2 * len(ps.roots(spans, "kf")) == 6
    for (m0, m1), span in pairs:
        a, b = ps.on_trace(span, off)
        assert m0 - err <= a < b <= m1 + err
    rec["trace"]["marks"]["step"] = rec["trace"]["marks"]["step"][1:]
    assert ps.alignment(rec, spans) is None
    profiling.reset()
