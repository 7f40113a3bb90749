"""Reduction of a torch.profiler trace to what the per-layer readers use:
the device's kernels (name, start, end, in microseconds), the host ranges
the solo loop marked (`frontend`, `step`), the window, the device's busy
time (the union of kernel intervals) and the longest idle gaps.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

MARKS = ("frontend", "step")


def union(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def reduce(prof) -> Dict:
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, marks = [], {m: [] for m in MARKS}
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if e.name not in MARKS:
                kernels.append((e.name, a, b))
        elif e.name in MARKS:
            marks[e.name].append((a, b))
    spans = [iv for v in marks.values() for iv in v]
    if not spans or not kernels:
        return {"kernels": kernels, "marks": marks, "window_us": 0.0,
                "busy_us": 0.0}
    w0 = min(a for a, _ in spans)
    w1 = max(b for _, b in spans)
    ivs = sorted((max(a, w0), min(b, w1)) for _, a, b in kernels
                 if b > w0 and a < w1)
    busy = union(ivs)
    gaps, end = [], w0
    for a, b in ivs:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    return {"kernels": kernels, "marks": marks, "window_us": w1 - w0,
            "busy_us": busy, "gaps": gaps}


def mark_at(red: Dict, t: float) -> str:
    """The mark (frontend or step) holding time t, or `between`."""
    for name, ivs in red["marks"].items():
        for a, b in ivs:
            if a <= t < b:
                return name
    return "between"


def breakdown(red: Dict, n: int = 10) -> Dict:
    by_name: Dict[str, float] = {}
    for name, a, b in red["kernels"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(red.get("gaps", []), key=lambda g: g[0] - g[1])[:n]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[mark_at(red, a), (b - a) * 1e-6]
                          for a, b in gaps]}
