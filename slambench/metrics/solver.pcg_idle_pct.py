"""Percent of PCG's time in which no kernel ran on the card: the traced
keyframes' `solve.pcg` spans, put on the trace's clock through the solo
loop's marks, less the union of the kernel intervals inside them, over
their total time."""
from slambench.yardstick import program_spans as ps


def read(rec):
    red = rec.get("trace")
    if not red or not red["kernels"]:
        return None
    spans = ps.program_spans()
    aligned = ps.alignment(rec, spans)
    if aligned is None:
        return None
    off = aligned[0]
    kernels = sorted(red["kernels"], key=lambda k: k[1])
    total = busy = 0.0
    for s in spans:
        if s["name"] == "solve.pcg":
            a, b = ps.on_trace(s, off)
            total += b - a
            busy += ps.busy_us(a, b, kernels)
    return 100.0 * (1.0 - busy / total) if total > 0 else None
