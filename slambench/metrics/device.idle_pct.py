"""Percent of the traced keyframes' span in which no kernel ran on the
card: 100 x (1 - union of kernel intervals / span)."""


def read(rec):
    red = rec.get("trace")
    if not red or not red["window_us"] or not red["kernels"]:
        return None
    return 100.0 * (1.0 - red["busy_us"] / red["window_us"])
