"""DBSCAN inputs shared by the port's CPU parity tests and its card tests
(numpy and the port only, no JAX: the card tests run where JAX is absent).

Cases: blobs; a full N = 1024 class; a chain longer than 64 hops (neither
version converges within its 64 sweeps, and the synchronous sweeps must
still agree); all points invalid; the (eps, min_samples) pairs of the
slice's four DBSCAN stages (tree and lightpole, noise and cluster; three
distinct pairs). For the batched two-stage call: a batch of such sets
with valid flags that are not a prefix, a 176-point class and the chain, and
a [2, 1024] batch shaped like a scan's. Above 1024 points (the kernel's
global-memory path): dense trunks, one dense blob that is a single cluster,
a chain of the whole set, all points invalid, and the dense scan of the
KITTI preset's test (tests/test_frontend.py:312-331).
"""
import numpy as np

from slide_slam_tpu_torch.frontend.clustering import stage_params
from slide_slam_tpu_torch.frontend.pipeline import forest_classes

# (eps, min_samples) of the two DBSCAN stages of the slice's classes
SLICE_PARAMS = sorted({(c.eps_noise, c.min_samples_noise)
                       for c in forest_classes() if c.model == "cylinder"}
                      | {(c.eps_cluster, c.min_samples_cluster)
                         for c in forest_classes() if c.model == "cylinder"})


def pad(pts, n):
    out = np.zeros((n, 3), np.float32)
    out[:len(pts)] = pts
    valid = np.zeros(n, bool)
    valid[:len(pts)] = True
    return out, valid


def blobs(n=128):
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal([0, 0, 0], 0.2, (40, 3)),
                          rng.normal([5, 5, 0], 0.2, (40, 3)),
                          rng.normal([10, 0, 0], 0.2, (30, 3)),
                          rng.uniform(-20, 20, (10, 3))])
    return pad(pts, n)


def trees(n=1024, seed=1):
    """A full class of trunk points at ~50 m world coordinates (where the
    Pallas |p|^2+|q|^2-2pq form loses ~1e-3 of d2)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(40, 60, (24, 2))
    pts = []
    for c in centers:
        th = rng.uniform(0, 2 * np.pi, 60)
        r = rng.uniform(0.15, 0.5)
        pts.append(np.column_stack([c[0] + r * np.cos(th),
                                    c[1] + r * np.sin(th),
                                    rng.uniform(0.1, 5.0, 60)]))
    pts = np.concatenate(pts)[:n]
    return pad(pts, n)


def chain(n=256):
    """150 points 0.5 m apart: one cluster whose labels need ~150 sweeps."""
    pts = np.zeros((150, 3))
    pts[:, 0] = 0.5 * np.arange(150)
    return pad(pts, n)


def invalid(n=128):
    pts, valid = blobs(n)
    return pts, np.zeros_like(valid)


def _cases():
    yield "blobs", blobs(), 0.8, 5
    yield "chain_gt_64_hops", chain(), 0.6, 2
    yield "all_invalid", invalid(), 0.8, 5
    for eps, ms in SLICE_PARAMS:
        yield f"n1024_eps{eps}_ms{ms}", trees(), eps, ms


CASES = list(_cases())


def class_params(name):
    """(eps_noise, ms_noise, eps_cluster, ms_cluster) of a slice class."""
    c = next(c for c in forest_classes() if c.name == name)
    return (c.eps_noise, c.min_samples_noise, c.eps_cluster,
            c.min_samples_cluster)


def scattered(n=256):
    """Two blobs whose valid flags are not a prefix: every third row and
    20 random rows are invalid."""
    rng = np.random.default_rng(7)
    pts = np.zeros((n, 3), np.float32)
    pts[:] = np.concatenate([rng.normal([45, 50, 1], 0.25, (n // 2, 3)),
                             rng.normal([52, 44, 2], 0.3, (n - n // 2, 3))])
    valid = np.ones(n, bool)
    valid[::3] = False
    valid[rng.integers(0, n, 20)] = False
    return pts, valid


def two_stage_batch(n=256):
    """[(name, (points [n, 3], valid [n]), (eps_1, ms_1, eps_2, ms_2))] for
    one batched two-stage call: the slice's three (eps, min_samples) pairs
    (tree and lightpole classes), valid flags that are not a prefix, a
    176-point class and the > 64-hop chain."""
    tree_pts, _ = trees(n=2048, seed=5)
    return [
        ("tree", trees(n=n, seed=4), class_params("tree")),
        ("lightpole_176", pad(tree_pts[:176], n), class_params("lightpole")),
        ("scattered_valid", scattered(n), class_params("tree")),
        ("chain_gt_64_hops", chain(n), (0.6, 2, 0.6, 2)),
    ]


def slice_batch():
    """A [2, 1024] batch shaped like a scan's: a full tree class and a
    176-point lightpole class, each with its class's parameters."""
    tree_pts, _ = trees(n=2048, seed=6)
    return [("tree", trees(), class_params("tree")),
            ("lightpole_176", pad(tree_pts[:176], 1024),
             class_params("lightpole"))]


def stack(batch):
    """points [C, n, 3], valid [C, n], params [C, 4] of a batch."""
    return (np.stack([p for _, (p, _), _ in batch]),
            np.stack([v for _, (_, v), _ in batch]),
            np.stack([stage_params(*a) for _, _, a in batch]))


BIG_SIZES = (1025, 1500, 4096, 8192)


def forest(n, seed=12):
    """n trunk points as in trees(), one trunk of 60 points for every 60
    points, in a square that grows with n (~1.2 trunks per 100 m^2)."""
    rng = np.random.default_rng(seed)
    k = -(-n // 60)
    side = 20.0 * np.sqrt(k / 24.0)
    pts = []
    for c in rng.uniform(40, 40 + side, (k, 2)):
        th = rng.uniform(0, 2 * np.pi, 60)
        r = rng.uniform(0.15, 0.5)
        pts.append(np.column_stack([c[0] + r * np.cos(th),
                                    c[1] + r * np.sin(th),
                                    rng.uniform(0.1, 5.0, 60)]))
    return pad(np.concatenate(pts)[:n], n)


def blob(n, seed=11):
    """n points in a 1 m cube: with eps 0.5, one cluster of every point."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32), np.ones(n, bool)


def big_cases(n):
    """[(name, (points [n, 3], valid [n]), eps, min_samples)] above 1024."""
    pts, valid = forest(n)
    line = np.zeros((n, 3), np.float32)
    line[:, 0] = 40.0 + 0.5 * np.arange(n)
    return [("trees", (pts, valid), *SLICE_PARAMS[0]),
            ("one_cluster", blob(n), 0.5, 5),
            ("chain_whole_set", (line, np.ones(n, bool)), 0.6, 2),
            ("scattered_valid", (pts, np.arange(n) % 3 != 0),
             *SLICE_PARAMS[-1]),
            ("all_invalid", (pts, np.zeros(n, bool)), *SLICE_PARAMS[0])]


def big_batch(n):
    """The big cases as one batched two-stage call."""
    return [(name, s, (eps, ms, eps, ms))
            for name, s, eps, ms in big_cases(n)]


def kitti_dense_batch(n=4096, seed=9):
    """The car, tree and lightpole sets of one dense scan of the kind the
    JAX package's KITTI preset test builds (tests/test_frontend.py:312-331:
    a 4000-point box, a 2000-point trunk, no lightpole), each padded to n,
    with kitti_pipeline_config()'s stage parameters."""
    from slide_slam_tpu_torch.frontend.pipeline import kitti_pipeline_config
    from slide_slam_tpu_torch.io.synthetic import (synth_box_points,
                                                   synth_tree_points)
    rng = np.random.default_rng(seed)
    sets = {"car": synth_box_points(rng, [8.0, 2.0, 0.75], [2.0, 1.0, 0.8],
                                    0.4, 4000),
            "tree": synth_tree_points(rng, [4.0, -4.0, 0.0], 0.3, n=2000),
            "lightpole": np.zeros((0, 3))}
    classes = {c.name: c for c in kitti_pipeline_config().classes}
    return [(name, pad(np.asarray(pts, np.float32)[:n], n),
             (classes[name].eps_noise, classes[name].min_samples_noise,
              classes[name].eps_cluster, classes[name].min_samples_cluster))
            for name, pts in sets.items()]
