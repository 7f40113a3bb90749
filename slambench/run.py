#!/usr/bin/env python3
"""The benchmark of slide_slam_tpu_torch: one cell, one run.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with as many CUDA cards as
the cell asks for. The cell (an entry of BENCHMARK.json's `workloads`)
names a configuration (slambench/configs/<config>.json) and its traffic
(slambench/workloads/<cell>.json, whose `driver` names a module of
slambench/drivers/). Set-up makes the inputs from the seed and warms the
cell's shapes up; the window then runs `--seconds` seconds; then the
run's outputs are judged against the plain reference by the judge that
the driver module names as `JUDGE` (the solo driver's: slambench/judge.py),
held to the workload's `limits` by `verdict`.

With --trace 0 the last line of standard output holds the cell's
end-to-end metrics; with --trace 1 its per-layer metrics, each read by
slambench/metrics/<metric>.py from the run's synchronised spans and a
torch.profiler trace of a few keyframes. The compared numbers and their
limits are printed last on standard error and last in the line, under
`checks`. Exits non-zero, printing no result, without the cards, without
the program beside this folder, or when JAX or the JAX package is loaded.
"""
from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "slambench")
FORBIDDEN = ("jax", "jaxlib", "flax", "slide_slam_tpu")
CACHE = os.path.join(ROOT, ".slambench_cache")


def forbidden_loaded():
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (slide_slam_tpu_torch is not slide_slam_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_of(manifest: dict, name: str):
    wl = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == wl["config"])
    return wl, conf


def metric_reader(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def verdict(values: dict, limits: dict):
    """(correct, [(name, value, limit)]) over the numbers with a limit."""
    rows = [(k, values.get(k), lim) for k, lim in limits.items()]
    ok = all(v is not None and v <= lim for _, v, lim in rows)
    return ok, rows


def run_cell(manifest: dict, cell: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", overrides=None):
    """One run of `cell`: (result line dict, [(name, value, limit)]).
    `overrides` (tests) updates the configuration and workload dicts.
    The driver module that the workload's `driver` names gives the run
    (`Driver`) and its judge (`JUDGE`: `program_side(rec)` takes what the
    run kept, `readings(cfg, work, traffic, side, device)` the compared
    numbers)."""
    import numpy as np
    import torch

    wl, conf = cell_of(manifest, cell)
    cfg = load_json(ROOT, conf["file"])
    work = load_json(BENCH, "workloads", f"{cell}.json")
    if overrides:
        overrides(cfg, work)
    driver_mod = importlib.import_module(f"slambench.drivers.{work['driver']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    drv = driver_mod.Driver(cfg, work, seed, device, trace)
    drv.setup()
    drv.sync()
    setup_s = time.time() - PROCESS_START
    n, lat = drv.window(seconds)
    drv.sync()
    drv.close()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.empty_cache()

    rec = drv.rec
    metrics = {}
    devinfo = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
               "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        from slambench.yardstick import trace as tr
        red = tr.reduce(rec.pop("profile")) if "profile" in rec else None
        rec["trace"] = red
        if red:
            devinfo["busy_s"] = red["busy_us"] * 1e-6
            devinfo["window_s"] = red["window_us"] * 1e-6
            breakdown = tr.breakdown(red)
        for m in manifest["per_layer"]:
            if _applies(m, cell):
                v = metric_reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {"kf_per_s": n / seconds,
                  "kf_latency_p90_ms": (float(np.percentile(lat, 90)) * 1e3
                                        if lat else None),
                  "setup_s": setup_s}
        for m in manifest["end_to_end"]:
            if _applies(m, cell):
                if values.get(m["name"]) is None:
                    raise RuntimeError(f"no value for {m['name']}")
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    judge = driver_mod.JUDGE
    side = judge.program_side(rec)
    values = judge.readings(cfg, work, drv.traffic, side, device)
    correct, rows = verdict(values, work["limits"])
    line = {"correct": bool(correct), "attempted": int(n), "failed": 0,
            "metrics": metrics, "device": devinfo}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return line, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the run stays inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    sys.path.insert(0, ROOT)
    manifest = load_json(ROOT, "BENCHMARK.json")
    wl, _ = cell_of(manifest, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"needs {wl['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec("slide_slam_tpu_torch") is None:
        print("the program (slide_slam_tpu_torch) is not beside slambench/",
              file=sys.stderr)
        return 2
    line, rows = run_cell(manifest, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    found = forbidden_loaded()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
