"""PCG iterations a keyframe: the mean over the traced keyframes of the
iterations that solver.pcg ran (its own device counter) in each `kf`
span's `solve.pcg` spans, the periodic full solve's included."""
import numpy as np

from slambench.yardstick import program_spans as ps


def read(rec):
    kfs = ps.keyframes()
    if not kfs:
        return None
    return float(np.mean([sum(d["attrs"].get("pcg_iters", 0) for d in below
                              if d["name"] == "solve.pcg")
                          for _, below in kfs]))
