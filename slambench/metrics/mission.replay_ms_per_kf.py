"""Host milliseconds a keyframe in folds of peer keyframes: the summed
duration of the window's `mission.replay` spans (SlamNode.replay_peers,
opened only where a peer has keyframes to fold: packing, the replay
dispatches and the solve after them) over the window's keyframes, every
robot's (`kf` spans). Spans are on for the whole traced window."""
from slambench.yardstick import program_spans as ps


def read(rec):
    spans = ps.program_spans()
    if not spans:
        return None
    xs = [s for s in spans if s["name"] == "mission.replay"]
    n = len(ps.roots(spans, "kf"))
    if not xs or not n:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in xs) * 1e-6 / n
