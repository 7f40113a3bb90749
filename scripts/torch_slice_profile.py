#!/usr/bin/env python3
"""Where the time goes in the port's raw-LiDAR solo mission on an NVIDIA card.

    python3 scripts/torch_slice_profile.py [first_keyframe] [n_keyframes] [out.json]

Runs the mission of chip_smoke.py (phase slice:raw_lidar_solo) on the card
up to first_keyframe + n_keyframes (default 24 + 12, a window that holds the
periodic full solve of keyframe 31) and traces the window with
torch.profiler. Prints one JSON line: per stage (frontend, keyframe step,
full solve) the host wall time, the device busy time inside it and the
number of kernel launches; the device's idle share over the window; and the
kernels that take the most device time; with out.json, also the full
table of kernels there. Needs a CUDA card; imports nothing of JAX.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from slide_slam_tpu_torch.config import forest_config, mission_capacity  # noqa: E402
from slide_slam_tpu_torch.frontend.lidar_pipeline import (  # noqa: E402
    LidarFrontend, LidarFrontendConfig, ground_truth_segmenter)
from slide_slam_tpu_torch.frontend.pipeline import (  # noqa: E402
    PipelineConfig, forest_classes)
from slide_slam_tpu_torch.io import synthetic  # noqa: E402
from slide_slam_tpu_torch.runtime import engine  # noqa: E402
from slide_slam_tpu_torch.runtime.node import SlamNode  # noqa: E402

STAGES = ("frontend", "keyframe_step", "full_solve")


def _union(intervals):
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def main(first=24, n=12, out_path=None):
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    m = synthetic.make_lidar_mission(n_keyframes=first + n)
    holder = {"pose": m.traj[0]}
    frontend = LidarFrontend(
        ground_truth_segmenter(m.world, lambda: holder["pose"]),
        LidarFrontendConfig(64, 1024, desired_period=0.0),
        PipelineConfig(classes=forest_classes()), device="cuda")
    cfg = forest_config().replace(
        number_of_robots=1, turn_off_intra_loop_closure=True,
        capacity=mission_capacity(150, n_cylinders=140))
    node = SlamNode(cfg, robot_id=0, device="cuda")

    def traced(name, fn):
        def run(*a, **k):
            with record_function(name):
                out = fn(*a, **k)
                torch.cuda.synchronize()
            return out
        return run
    # the node calls engine.<fn> through the module: trace both stages there
    engine.keyframe_step_fused = traced("keyframe_step",
                                        engine.keyframe_step_fused)
    engine.solve_full = traced("full_solve", engine.solve_full)

    def step(i):
        holder["pose"] = m.traj[i]
        stamp = 1000.0 + 0.5 * i
        scan = m.scans[i]
        with record_function("frontend"):
            obs = frontend.process_scan(stamp, scan,
                                        np.zeros(len(scan), np.float32),
                                        m.odom[i])
            torch.cuda.synchronize()
        node.process_keyframe(stamp, m.odom[i], obs)

    for i in range(first):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + n):
            step(i)
        torch.cuda.synchronize()

    events = prof.events()
    # device-side activity; the stage annotations are mirrored on the
    # device timeline under their own names and are not kernels
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in STAGES]
    k_iv = [(e.time_range.start, e.time_range.end) for e in kernels]
    ranges = [e for e in events if e.name in STAGES
              and e.device_type == torch.autograd.DeviceType.CPU]
    out = {"card": card, "keyframes": [first, first + n],
           "device_events": len(kernels)}
    if not kernels:
        out["note"] = "the profiler recorded no device time"
    stages = {}
    for name in STAGES:
        rs = [e for e in ranges if e.name == name]
        wall = sum(e.time_range.end - e.time_range.start for e in rs)
        busy, launches = 0.0, 0
        for e in rs:
            a, b = e.time_range.start, e.time_range.end
            inside = [(max(x, a), min(y, b)) for x, y in k_iv
                      if y > a and x < b]
            busy += _union(inside)
            launches += len(inside)
        stages[name] = dict(calls=len(rs), wall_ms=wall / 1e3,
                            device_busy_ms=busy / 1e3,
                            kernels=launches,
                            idle_share=(1 - busy / wall) if wall else None)
    win = (min(e.time_range.start for e in ranges),
           max(e.time_range.end for e in ranges))
    busy = _union([(max(x, win[0]), min(y, win[1])) for x, y in k_iv
                   if y > win[0] and x < win[1]])
    out["window_ms"] = (win[1] - win[0]) / 1e3
    out["device_busy_ms"] = busy / 1e3
    out["idle_share"] = 1 - busy / (win[1] - win[0])
    out["stages"] = stages
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    out["top_kernels"] = [dict(name=k[:90], launches=c, ms=t)
                          for k, (c, t) in top[:12]]
    if out_path:
        full = dict(out, all_kernels=[dict(name=k, launches=c, ms=t)
                                      for k, (c, t) in top])
        Path(out_path).write_text(json.dumps(full, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    a = sys.argv[1:]
    sys.exit(main(*(int(x) for x in a[:2]), *a[2:3]))
