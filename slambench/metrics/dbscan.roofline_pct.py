"""The DBSCAN kernel's share of its roofline over the traced keyframes:
the least time the card could take for the work these launches' inputs
need (slambench/yardstick/roofline.py, frozen), over the kernel's device
time in the profiler's trace, in percent. Up to six launches, evenly
spread, are counted, each with its own kernels (matched in order)."""
from slambench.yardstick import roofline

MAX_LAUNCHES = 6


def read(rec):
    red = rec.get("trace")
    launches = rec.get("profiled_dbscan") or []
    if not red or not launches:
        return None
    ks = [(a, b) for name, a, b in red["kernels"] if "dbscan" in name]
    if not ks or len(ks) % len(launches):
        return None
    g = len(ks) // len(launches)
    pick = sorted({round(i * (len(launches) - 1) / max(MAX_LAUNCHES - 1, 1))
                   for i in range(MAX_LAUNCHES)})
    bound_ms = kernel_ms = 0.0
    for i in pick:
        points, valid, params = launches[i]
        bound_ms += roofline.launch_bound_ms(points, valid, params)
        kernel_ms += sum(b - a for a, b in ks[i * g:(i + 1) * g]) * 1e-3
    return 100.0 * bound_ms / kernel_ms if kernel_ms > 0 else None
