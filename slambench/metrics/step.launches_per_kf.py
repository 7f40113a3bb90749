"""CUDA kernels the profiler saw start inside the solo loop's `step` ranges
(SlamNode.process_keyframe), per keyframe of the traced keyframes."""


def read(rec):
    red = rec.get("trace")
    if not red or not red["marks"]["step"] or not red["kernels"]:
        return None
    steps = red["marks"]["step"]
    n = sum(1 for _, a, _ in red["kernels"]
            if any(s <= a < e for s, e in steps))
    return n / len(steps)
