"""The program's own spans (slide_slam_tpu_torch/runtime/profiling.py),
read after a traced run and put on the clock of the profiler's trace.

The program records spans while a torch.profiler session records, so a
`--trace 1` run holds the spans of the profiled keyframes and no others.
The spans run on the host's perf_counter_ns, the trace on the profiler's
clock; the solo loop's marks join the two. Each `step` mark holds one root
`kf` span (SlamNode.process_keyframe) and each `frontend` mark one root
`scan` span (LidarFrontend.process_scan), in order. The offset is the
median over the keyframes of (step mark start - kf span start); the
alignment error is the largest distance of one keyframe's offset from it.
A program that records no spans gives None everywhere.
"""
from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional

PAIRS = (("step", "kf"), ("frontend", "scan"))


def program_spans() -> Optional[List[Dict]]:
    """The program's closed spans, or None where it keeps none."""
    try:
        from slide_slam_tpu_torch.runtime import profiling
    except ImportError:
        return None
    export = getattr(profiling, "spans", None)
    if export is None:
        return None
    return export()["spans"] or None


def roots(spans: List[Dict], name: str) -> List[Dict]:
    """Root spans called `name`, by start."""
    return sorted((s for s in spans if s["parent"] is None
                   and s["name"] == name), key=lambda s: s["start_ns"])


def descendants(spans: List[Dict]) -> Dict[int, List[Dict]]:
    """Span id -> every span below it."""
    kids: Dict[int, List[Dict]] = {}
    for s in spans:
        if s["parent"] is not None:
            kids.setdefault(s["parent"], []).append(s)
    out: Dict[int, List[Dict]] = {}

    def walk(i):
        if i not in out:
            below = []
            for c in kids.get(i, []):
                below.append(c)
                below.extend(walk(c["id"]))
            out[i] = below
        return out[i]
    for s in spans:
        walk(s["id"])
    return out


def keyframes(spans: Optional[List[Dict]] = None):
    """[(kf root span, its descendants)] of the traced keyframes."""
    spans = program_spans() if spans is None else spans
    if not spans:
        return []
    below = descendants(spans)
    return [(k, below[k["id"]]) for k in roots(spans, "kf")]


def alignment(rec: Dict, spans: Optional[List[Dict]] = None):
    """(offset_us, error_us, [(mark, span)]) that put the program's spans
    on the trace's clock (t_trace = start_ns / 1e3 + offset_us), or None
    where the trace has no `step` marks or a mark count is not the spans'.
    The offset and its error come from the `kf` spans alone: a `step` mark
    opens right where process_keyframe starts, while a `frontend` mark
    also holds the loop's own work before process_scan starts."""
    red = rec.get("trace")
    spans = program_spans() if spans is None else spans
    if not red or not spans:
        return None
    pairs = []
    for mark, name in PAIRS:
        marks = sorted(red["marks"].get(mark, []))
        rs = roots(spans, name)
        if len(marks) != len(rs):
            return None
        pairs += list(zip(marks, rs))
    offs = [m[0] - s["start_ns"] * 1e-3 for m, s in pairs
            if s["name"] == "kf"]
    if not offs:
        return None
    off = statistics.median(offs)
    return off, max(abs(o - off) for o in offs), pairs


def on_trace(span: Dict, offset_us: float):
    """A span's (start, end) on the trace's clock, in microseconds."""
    return span["start_ns"] * 1e-3 + offset_us, span["end_ns"] * 1e-3 + \
        offset_us


def busy_us(a: float, b: float, kernels) -> float:
    """Time in [a, b) with some kernel running; `kernels` [(name, start,
    end)] sorted by start."""
    longest = max((e - s for _, s, e in kernels), default=0.0)
    lo = bisect.bisect_left(kernels, a - longest, key=lambda k: k[1])
    hi = bisect.bisect_left(kernels, b, key=lambda k: k[1])
    total, end = 0.0, a
    for _, s, e in kernels[lo:hi]:
        s, e = max(s, a), min(e, b)
        if e > end:
            total += e - max(s, end)
            end = e
    return total
