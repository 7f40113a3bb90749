"""Host milliseconds a keyframe that the mission's main thread stood
blocked on a search still running on its worker: the summed duration of
the window's `closure.wait` spans over the window's keyframes, every
robot's (`kf` spans); 0 where no search was waited for. Spans are on for
the whole traced window; a program without the team's spans (no
`comm.exchange`) reads nothing."""
from slambench.yardstick import program_spans as ps


def read(rec):
    spans = ps.program_spans()
    if not spans or not any(s["name"] == "comm.exchange" for s in spans):
        return None
    n = len(ps.roots(spans, "kf"))
    if not n:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans
               if s["name"] == "closure.wait") * 1e-6 / n
