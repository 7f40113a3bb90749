"""Median milliseconds of PCG a keyframe, on the host's clock: over the
traced keyframes without a periodic full solve, the summed duration of
each `kf` span's `solve.pcg` spans.

Host time under the profiler: the program records spans only while the
traced run's torch.profiler session records, and the profiler stretches
a keyframe's host time about 1.6-1.7x on the H100's host (step.ms_p50,
timed over the whole window without it, is not comparable). Its cost
per launch goes with the launches, so a change that cuts launches reads
a larger gain here than untraced. Read PCG's cost from
solver.pcg_iters_per_kf and the launches; this number compares runs of
one tree under one profiler."""
import numpy as np

from slambench.yardstick import program_spans as ps


def read(rec):
    xs = [sum(d["end_ns"] - d["start_ns"] for d in below
              if d["name"] == "solve.pcg") * 1e-6
          for kf, below in ps.keyframes()
          if not kf["attrs"].get("full_solve")]
    return float(np.median(xs)) if xs else None
