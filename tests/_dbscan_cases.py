"""DBSCAN inputs shared by the port's CPU parity tests and its card tests
(numpy and the port only, no JAX: the card tests run where JAX is absent).

Cases: blobs; a full N = 1024 class; a chain longer than 64 hops (neither
version converges within its 64 sweeps, and the synchronous sweeps must
still agree); all points invalid; the (eps, min_samples) pairs of the
slice's four DBSCAN stages (tree and lightpole, noise and cluster; three
distinct pairs). For the batched two-stage call: a batch of such sets
with valid flags that are not a prefix, a 176-point class and the chain, and
a [2, 1024] batch shaped like a scan's.
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
