"""Host milliseconds a keyframe in applying finished searches on the main
thread: the summed duration of the window's `closure.apply` spans (merge
acceptance with its `closure.polish`, intra closure factors and their
thorough solves) over the window's keyframes, every robot's (`kf`
spans). Spans are on for the whole traced window."""
from slambench.yardstick import program_spans as ps


def read(rec):
    spans = ps.program_spans()
    if not spans:
        return None
    xs = [s for s in spans if s["name"] == "closure.apply"]
    n = len(ps.roots(spans, "kf"))
    if not xs or not n:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in xs) * 1e-6 / n
