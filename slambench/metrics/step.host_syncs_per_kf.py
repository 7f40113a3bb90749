"""Blocking device-to-host reads a keyframe: the mean over the traced
keyframes of the reads the program counted (`host_reads` on its
`sync.<site>` spans) inside each `kf` span: PCG stop flags, the line
search's accept flag, pose fetches."""
import numpy as np

from slambench.yardstick import program_spans as ps


def read(rec):
    kfs = ps.keyframes()
    if not kfs:
        return None
    return float(np.mean([sum(d["attrs"].get("host_reads", 0)
                              for d in below) for _, below in kfs]))
