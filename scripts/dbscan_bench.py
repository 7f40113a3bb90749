#!/usr/bin/env python3
"""Device time of the DBSCAN kernel per scan on an NVIDIA card: across
cluster sizes, stage by stage, and against other builds of the kernel.

    python scripts/dbscan_bench.py [--old OLD.cu] [--variants A.cu ...]
        [--breakdown] [--out results.json]

Inputs: the chip_smoke mission's keyframe with the largest tree class, its
tree and lightpole classes padded to [2, 1024]. Every time is device time
from a CUDA graph of back-to-back launches (no host in the way):

* `scan`: the current kernel, one launch for both classes and both stages,
  for every cluster size 1, 2, 4, 8, 16 (16 needs a GPC with 16 free SMs;
  a refused launch is reported, not hidden), beside an empty kernel of the
  same launch shape (the launch floor) and the kernel's own duration from
  torch.profiler;
* `breakdown`: the current kernel on the scan batch and on each class
  alone, one or two stages, sweeps capped at 0 or 64 (the label sweeps'
  share), at cluster sizes 1, 8, 16;
* `old`: a source with the single-problem C entry point
  `dbscan_launch(pts, valid_i32, labels, n, eps2, min_samples, max_iters,
  stream)` (one block per problem, one stage per launch), built with the
  same flags, timed for the scan's four launches (stage-2 valid flags made
  beforehand), in turns with the current kernel: old, new, new, old;
* `variants`: sources with the current C entry point, each in turns with
  the current kernel (current, variants, variants reversed, current) at
  cluster sizes 4, 8, 16, labels checked against the plain version;
* `parent`: a source with the C entry point of the N <= 1024-only kernel
  (no scratch argument, e.g. the parent commit's csrc/dbscan.cu), timed in
  turns with the current kernel (parent, current, current, parent) at the
  cluster size the library picks, on the forest scan's [2, 1024] batch and
  on the urban path's [3, 1024] car/tree/lightpole batch (chip_smoke's
  kernel:dbscan and kernel:dbscan:urban inputs), labels checked.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from slide_slam_tpu_torch import kernels  # noqa: E402
from slide_slam_tpu_torch.frontend import clustering  # noqa: E402
from slide_slam_tpu_torch.frontend.pipeline import forest_classes  # noqa: E402
from slide_slam_tpu_torch.io import synthetic  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int


def build_other(src: Path) -> ctypes.CDLL:
    out = ROOT / "scratch_chip" / "_build" / f"lib{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    return ctypes.CDLL(str(out))


def scan_batch():
    mission = synthetic.make_lidar_mission()
    k = max(range(len(mission.scans)), key=lambda i: len(mission.scans[i]))
    specs = {c.name: c for c in forest_classes() if c.model == "cylinder"}
    pts, valid, params = [], [], []
    for name, (pad, v) in chip_smoke.slice_inputs(mission, k).items():
        s = specs[name]
        pts.append(pad)
        valid.append(v)
        params.append(clustering.stage_params(
            s.eps_noise, s.min_samples_noise, s.eps_cluster,
            s.min_samples_cluster))
    return [torch.as_tensor(np.stack(a), device="cuda")
            for a in (pts, valid, params)]


def plain_one_stage(points, valid, eps2, min_samples):
    """The plain version of one DBSCAN stage, eps^2 given as float32."""
    return clustering._dbscan_plain(
        points, valid, torch.tensor(np.float32(eps2), device=points.device),
        int(min_samples), 64)


def with_current_entry(lib: ctypes.CDLL, scratch: bool = True) -> ctypes.CDLL:
    """The current C entry point, or (scratch=False) the N <= 1024-only
    one, which has no scratch argument."""
    lib.dbscan_two_stage_launch.argtypes = (
        [P, P, P, P] + [P] * scratch + [I, I, I, I, I, P])
    lib.dbscan_two_stage_launch.restype = I
    lib.no_scratch = not scratch
    return lib


def launcher(lib, pts, valid, params, stages=2, max_iters=64, cluster=0):
    """A launch of a library with the current C entry point (or the
    N <= 1024-only one, for a library marked no_scratch)."""
    def fn():
        lab = torch.empty(valid.shape, dtype=torch.int32, device="cuda")
        scratch = () if getattr(lib, "no_scratch", False) else (None,)
        err = lib.dbscan_two_stage_launch(
            pts.data_ptr(), valid.view(torch.uint8).data_ptr(),
            params.data_ptr(), lab.data_ptr(), *scratch, pts.shape[0],
            pts.shape[1], stages, max_iters, cluster,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return lab
    return fn


def old_scan_fn(lib, pts, valid, params):
    """The scan's four single-problem launches of the old kernel."""
    lib.dbscan_launch.argtypes = [P, P, P, I, ctypes.c_float, I, I, P]
    lib.dbscan_launch.restype = I
    probs = []
    for c in range(pts.shape[0]):
        e1, m1, e2, m2 = params[c].tolist()
        lab1 = plain_one_stage(pts[c], valid[c], e1, m1)
        for v, e, m in ((valid[c], e1, m1), (valid[c] & (lab1 >= 0), e2, m2)):
            probs.append((pts[c].contiguous(), v.to(torch.int32).contiguous(),
                          torch.empty(pts.shape[1], dtype=torch.int32,
                                      device="cuda"), float(e), int(m)))

    def fn():
        stream = torch.cuda.current_stream().cuda_stream
        for p, v, lab, e, m in probs:
            err = lib.dbscan_launch(p.data_ptr(), v.data_ptr(), lab.data_ptr(),
                                    pts.shape[1], e, m, 64, stream)
            if err:
                raise RuntimeError(f"old kernel launch failed: {err}")
    return fn, probs


def urban_batch():
    """The urban path's [3, 1024] car/tree/lightpole batch of
    chip_smoke.phase_kernel_urban: the keyframe with the most points in
    those classes, padded to 1024, with the outdoor classes' parameters."""
    from slide_slam_tpu_torch.frontend.pipeline import outdoor_classes
    urban = synthetic.make_lidar_mission(n_cars=chip_smoke.URBAN_CARS)
    specs = [c for c in outdoor_classes() if c.model != "ground"]
    names = tuple((c.name, c.label) for c in specs)

    def clustered(k):
        _, labels = chip_smoke.class_labels(urban, k)
        return sum(min(int((labels == lab).sum()), 1024) for _, lab in names)
    k = max(range(len(urban.scans)), key=clustered)
    inputs = chip_smoke.slice_inputs(urban, k, names)
    cuda = lambda a: torch.as_tensor(a, device="cuda")
    return (torch.stack([cuda(inputs[c.name][0]) for c in specs]),
            torch.stack([cuda(inputs[c.name][1]) for c in specs]),
            torch.stack([cuda(clustering.stage_params(
                c.eps_noise, c.min_samples_noise, c.eps_cluster,
                c.min_samples_cluster)) for c in specs]))


def parent_turns(cur, parent):
    """The current kernel and a parent build of the N <= 1024-only kernel
    in turns (parent, current, current, parent) at the auto cluster size,
    on the forest scan and the urban batch."""
    parent = with_current_entry(parent, scratch=False)
    out = {}
    for name, (pts, valid, params) in (("forest_c2", scan_batch()),
                                       ("urban_c3", urban_batch())):
        ref = clustering.two_stage_cluster_reference(pts, valid, params)
        fns = {"parent": launcher(parent, pts, valid, params),
               "current": launcher(cur, pts, valid, params)}
        equal = {w: bool(torch.equal(f(), ref)) for w, f in fns.items()}
        out[name] = {"labels_equal": equal,
                     "turns": [(w, us(fns[w])) for w in
                               ("parent", "current", "current", "parent")]}
    return out


def profiled_kernel_us(fn, reps=50):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if "dbscan_kernel" in e.key:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            return total / e.count
    return None


def us(fn):
    return chip_smoke.graph_ms(fn) * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, help="older single-problem source")
    ap.add_argument("--variants", type=Path, nargs="*", default=[],
                    help="sources with the current C entry point")
    ap.add_argument("--parent", type=Path,
                    help="a source with the N <= 1024-only C entry point")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: dbscan_bench.py measures on a CUDA card", file=sys.stderr)
        return 1
    pts, valid, params = scan_batch()
    ref = clustering.two_stage_cluster_reference(pts, valid, params)
    cur = clustering._lib()
    res = {"card": chip_smoke.card_line(),
           "auto_cluster": clustering.auto_cluster_size(),
           "valid_points": valid.sum(1).tolist(), "scan_us": {}}
    for cl in (1, 2, 4, 8, 16):
        new = launcher(cur, pts, valid, params, cluster=cl)
        try:
            got = new()
            torch.cuda.synchronize()
        except RuntimeError as e:
            res["scan_us"][cl] = {"error": str(e)}
            continue
        res["scan_us"][cl] = {
            "labels_equal": bool(torch.equal(got, ref)), "kernel": us(new),
            "floor": us(lambda: clustering.launch_empty(pts.shape[0], cl)),
            "profiler": profiled_kernel_us(new)}
    if a.breakdown:
        res["breakdown_us"] = {}
        for name, sl in (("scan", slice(0, 2)), ("tree", slice(0, 1)),
                         ("lightpole", slice(1, 2))):
            p, v, q = (t[sl].contiguous() for t in (pts, valid, params))
            for cl in (1, 8, 16):
                for stages in (1, 2):
                    for mi in (0, 64):
                        key = f"{name} cluster{cl} stages{stages} sweeps{mi}"
                        res["breakdown_us"][key] = us(
                            launcher(cur, p, v, q, stages, mi, cl))
    if a.old:
        old, probs = old_scan_fn(build_other(a.old), pts, valid, params)
        old()
        torch.cuda.synchronize()
        old_ok = all(torch.equal(lab, plain_one_stage(p, v.bool(), e, m))
                     for p, v, lab, e, m in probs)
        new = launcher(cur, pts, valid, params)
        res["old_turns_us"] = {
            "cluster": clustering.auto_cluster_size(),
            "old_labels_equal": old_ok,
            "turns": [(w, us(old if w == "old" else new))
                      for w in ("old", "new", "new", "old")],
            "old_profiler_per_launch": profiled_kernel_us(old)}
    if a.variants:
        libs = {"current": cur}
        libs.update({src.stem: with_current_entry(build_other(src))
                     for src in a.variants})
        for name, lib in libs.items():
            got = launcher(lib, pts, valid, params, cluster=8)()
            res[f"{name} labels_equal"] = bool(torch.equal(got, ref))
        order = list(libs) + list(libs)[::-1]
        res["variant_turns_us"] = [
            (name, cl, us(launcher(libs[name], pts, valid, params,
                                   cluster=cl)))
            for name in order for cl in (4, 8, 16)]
    if a.parent:
        res["parent_turns_us"] = parent_turns(cur, build_other(a.parent))
    res["clocks"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
