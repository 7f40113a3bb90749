#!/usr/bin/env python3
"""The time by phase of the dense-bitmask N > 1024 DBSCAN kernel that the
sparse one replaced (dbscan_big_kernel of csrc/dbscan.cu at commit
0f2f81a), on an NVIDIA card: clock stamps patched in at its phase
boundaries (compaction and boxes, build, sweeps with border points) in the
layout of chip_smoke.dbscan_stage_split, on chip_smoke's KITTI sets at
the KITTI_SPLIT_SIZES it takes (up to 12288). The patches fit that source
only.

    git show 0f2f81a:slide_slam_tpu_torch/csrc/dbscan.cu > scratch_chip/dbscan_0f2f81a.cu
    python scripts/dbscan_parent_split.py scratch_chip/dbscan_0f2f81a.cu
"""
import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from dbscan_bench import build_other, with_current_entry  # noqa: E402
from slide_slam_tpu_torch import kernels  # noqa: E402
from slide_slam_tpu_torch.frontend import clustering  # noqa: E402


# clock stamps for the dense-bitmask dbscan_big_kernel (commit 0f2f81a) in
# the layout of chip_smoke.dbscan_stage_split (chip_smoke.STAMPS a CTA): [0]
# start, [1] before the stages, per stage s [2 + 4s] compacted, [3 + 4s]
# built, [4 + 4s] = [5 + 4s] swept with border points, [12] / [13]
# globaltimer at start / end
STAMP_DEFS = r"""
__device__ long long* g_clocks = nullptr;
#define STAMP_C(k) do { if (threadIdx.x == 0 && g_clocks) \
    g_clocks[blockIdx.x * 24 + (k)] = clock64(); } while (0)
#define STAMP_T(k) do { if (threadIdx.x == 0 && g_clocks) { long long t_; \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
    g_clocks[blockIdx.x * 24 + (k)] = t_; } } while (0)
"""
STAMPS = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n" + STAMP_DEFS),
    ("  const uint8_t* v = valid + static_cast<size_t>(set) * n;\n\n"
     "  // -1 everywhere first",
     "  const uint8_t* v = valid + static_cast<size_t>(set) * n;\n"
     "  STAMP_T(12);\n  STAMP_C(0);\n\n  // -1 everywhere first"),
    ("  for (int stage = 0; stage < stages; ++stage) {\n"
     "    const float eps2 = params[set * 4 + 2 * stage];\n"
     "    const int min_samples = static_cast<int>(params[set * 4 + 2 * "
     "stage + 1]);\n    const int nv = compact_big(",
     "  STAMP_C(1);\n  for (int stage = 0; stage < stages; ++stage) {\n"
     "    const float eps2 = params[set * 4 + 2 * stage];\n"
     "    const int min_samples = static_cast<int>(params[set * 4 + 2 * "
     "stage + 1]);\n    const int nv = compact_big("),
    ("stage > 0 ? out1 : nullptr, n);\n",
     "stage > 0 ? out1 : nullptr, n);\n    STAMP_C(2 + 4 * stage);\n"),
    ("min_samples);\n    __threadfence();\n    cluster.sync();\n",
     "min_samples);\n    __threadfence();\n    cluster.sync();\n"
     "    STAMP_C(3 + 4 * stage);\n"),
    ("max_iters,\n              cluster);\n",
     "max_iters,\n              cluster);\n    STAMP_C(4 + 4 * stage);\n"
     "    STAMP_C(5 + 4 * stage);\n"),
    ("      cluster.sync();\n    }\n  }\n}\n\n// Same launch shape",
     "      cluster.sync();\n    }\n  }\n  STAMP_T(13);\n}\n\n"
     "// Same launch shape"),
]
STAMP_ENTRY = """
extern "C" int dbscan_set_clock_buffer(void* buf) {
  long long* p = static_cast<long long*>(buf);
  return static_cast<int>(cudaMemcpyToSymbol(g_clocks, &p, sizeof(p)));
}
"""


def stamped_parent(src: Path) -> ctypes.CDLL:
    """csrc/dbscan.cu of commit 0f2f81a with clock stamps at the phase
    boundaries of its N > 1024 kernel, built as another library."""
    text = src.read_text()
    for old, new in STAMPS:
        if text.count(old) != 1:
            raise RuntimeError(f"{src}: no unique anchor {old[:60]!r}")
        text = text.replace(old, new)
    out = ROOT / "scratch_chip" / f"{src.stem}_stamped.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text + STAMP_ENTRY)
    return build_other(out)


def main():
    if not torch.cuda.is_available():
        print("FAIL: dbscan_parent_split.py measures on a CUDA card",
              file=sys.stderr)
        return 1
    old = with_current_entry(stamped_parent(Path(sys.argv[1])))
    load = kernels.load
    # the split's stamped library in place of the current kernel's
    kernels.load = lambda name, defines=(): (
        old if tuple(defines) == chip_smoke.CLOCKS else load(name, defines))
    out = {}
    for n in (n for n in chip_smoke.KITTI_SPLIT_SIZES
              if n <= old.dbscan_max_points()):
        pts, valid, params = (torch.as_tensor(x, device="cuda")
                              for x in chip_smoke.kitti_sets(n))
        ref = clustering.two_stage_cluster_reference(pts, valid, params)
        out[n] = chip_smoke.dbscan_stage_split(pts, valid, params, ref)
    print(chip_smoke.card_line())
    print("parent_split_ms", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
