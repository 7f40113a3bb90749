"""Median milliseconds of one closure search on its worker thread: the
window's `closure.search` spans (SlideGraph with CLIPPER, or SlideMatch,
with the chain and map fetches of an intra search), every kind. Spans are
on for the whole traced window."""
import numpy as np

from slambench.yardstick import program_spans as ps


def read(rec):
    spans = ps.program_spans()
    xs = [(s["end_ns"] - s["start_ns"]) * 1e-6 for s in spans or []
          if s["name"] == "closure.search"]
    return float(np.median(xs)) if xs else None
