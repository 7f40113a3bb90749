"""Data association ops: the port (on the CPU) vs the JAX package.

Submap top-K, the three pairwise distances and match_nearest, on random maps
built so that many distances are exactly equal (integer grids, duplicated
rows, integer distance matrices). Indices and masks must be IDENTICAL: the
port breaks ties by lower index as lax.top_k and jnp.argmin do. Distances
are the same float32 formulas and agree to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_slam_tpu import objects as jobj
from slide_slam_tpu.ops import association as jassoc
from slide_slam_tpu.ops import distances as jdist
from slide_slam_tpu.ops import submap as jsubmap
from slide_slam_tpu_torch import objects as tobj
from slide_slam_tpu_torch.ops import association as tassoc
from slide_slam_tpu_torch.ops import distances as tdist
from slide_slam_tpu_torch.ops import submap as tsubmap

DIST_TOL = 1e-5


def _grid_map(rng, n):
    """Centroids on a 1 m integer grid with duplicated rows: distances from
    an integer query tie exactly, in float32 on both sides."""
    c = rng.integers(-6, 7, (n, 3)).astype(np.float32)
    c[n // 2:] = c[: n - n // 2]
    valid = rng.uniform(size=n) > 0.2
    return c, valid


@pytest.mark.parametrize("n,k", [(64, 8), (64, 50), (40, 50), (200, 30)])
def test_topk_nearest_tie_order(n, k):
    rng = np.random.default_rng(n + k)
    c, valid = _grid_map(rng, n)
    q = rng.integers(-2, 3, 3).astype(np.float32)
    j_idx, j_mask = jsubmap.topk_nearest(jnp.asarray(c), jnp.asarray(valid),
                                         jnp.asarray(q), k)
    t_idx, t_mask = tsubmap.topk_nearest(torch.as_tensor(c),
                                         torch.as_tensor(valid),
                                         torch.as_tensor(q), k)
    assert t_idx.dtype == torch.int32
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


def _cylinders(rng, n, with_dups=True):
    root = np.concatenate([rng.uniform(-15, 15, (n, 2)),
                           rng.uniform(-0.3, 0.3, (n, 1))], 1)
    ray = rng.normal(0, 0.05, (n, 3)) + [0, 0, 1.0]
    ray /= np.linalg.norm(ray, axis=1, keepdims=True)
    if with_dups:
        root[n // 2:] = root[: n - n // 2]
        ray[n // 2:] = ray[: n - n // 2]
    radius = rng.uniform(0.1, 0.5, n)
    label = rng.choice([8, 9], n).astype(np.int32)
    valid = rng.uniform(size=n) > 0.2
    return (root.astype(np.float32), ray.astype(np.float32),
            radius.astype(np.float32), label, valid)


def _boxes(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.uniform(-15, 15, (n, 3))
    pose = np.concatenate([q, t], 1).astype(np.float32)
    pose[n // 2:] = pose[: n - n // 2]
    scale = rng.uniform(0.5, 3.0, (n, 3)).astype(np.float32)
    label = rng.choice([1, 2], n).astype(np.int32)
    valid = rng.uniform(size=n) > 0.2
    return pose, scale, label, valid


def _both(jcls, tcls, arrays):
    return (jcls(*(jnp.asarray(a) for a in arrays)),
            tcls(*(torch.as_tensor(a) for a in arrays)))


FAMILIES = {
    "cylinder": (lambda rng, n: _cylinders(rng, n), jobj.Cylinders,
                 tobj.Cylinders, jdist.cylinder_pairwise,
                 tdist.cylinder_pairwise),
    "cuboid": (_boxes, jobj.Cuboids, tobj.Cuboids, jdist.cuboid_pairwise,
               tdist.cuboid_pairwise),
    "ellipsoid": (_boxes, jobj.Ellipsoids, tobj.Ellipsoids,
                  jdist.ellipsoid_pairwise, tdist.ellipsoid_pairwise),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pairwise_distances(family):
    make, jcls, tcls, jfn, tfn = FAMILIES[family]
    rng = np.random.default_rng(len(family))
    ja, ta = _both(jcls, tcls, make(rng, 24))
    jb, tb = _both(jcls, tcls, make(rng, 40))
    want = np.asarray(jfn(ja, jb))
    got = tfn(ta, tb).numpy()
    assert got.shape == want.shape == (24, 40)
    np.testing.assert_allclose(got, want, rtol=DIST_TOL, atol=DIST_TOL)
    # the label / validity gate is exact
    np.testing.assert_array_equal(got == tdist.BIG, want == jdist.BIG)


@pytest.mark.parametrize("margin", [0.0, 0.5])
def test_match_nearest_with_ties(margin):
    """Integer distance matrices: every row has ties, some at the threshold,
    the BIG sentinel fills whole rows."""
    rng = np.random.default_rng(7)
    d = rng.integers(0, 6, (48, 30)).astype(np.float32)
    d[::7] = jdist.BIG
    thresh = 3.0
    want = np.asarray(jassoc.match_nearest(jnp.asarray(d), thresh, margin))
    got = tassoc.match_nearest(torch.as_tensor(d), thresh, margin)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    sub = rng.permutation(200)[:30].astype(np.int32)
    np.testing.assert_array_equal(
        tassoc.to_global_indices(got, torch.as_tensor(sub)).numpy(),
        np.asarray(jassoc.to_global_indices(jnp.asarray(want),
                                            jnp.asarray(sub))))


def test_submap_association_end_to_end():
    """top-K submap gather + cylinder distances + match, as the engine runs
    them, on a map with duplicated landmarks."""
    rng = np.random.default_rng(11)
    m = _cylinders(rng, 96)
    s = _cylinders(rng, 20, with_dups=False)
    jm, tm = _both(jobj.Cylinders, tobj.Cylinders, m)
    js, ts = _both(jobj.Cylinders, tobj.Cylinders, s)
    q = np.zeros(3, np.float32)
    j_idx, j_mask = jsubmap.topk_nearest(jm.centroid(), jm.valid,
                                         jnp.asarray(q), 50)
    t_idx, t_mask = tsubmap.topk_nearest(tm.centroid(), tm.valid,
                                         torch.as_tensor(q), 50)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    jsub = jobj.Cylinders(*(a[j_idx] for a in jm))._replace(
        valid=jm.valid[j_idx] & j_mask)
    tsub = tobj.Cylinders(*(a[t_idx.long()] for a in tm))._replace(
        valid=tm.valid[t_idx.long()] & t_mask)
    jmatch = jassoc.to_global_indices(
        jassoc.match_nearest(jdist.cylinder_pairwise(js, jsub), 3.0), j_idx)
    tmatch = tassoc.to_global_indices(
        tassoc.match_nearest(tdist.cylinder_pairwise(ts, tsub), 3.0), t_idx)
    np.testing.assert_array_equal(tmatch.numpy(), np.asarray(jmatch))
    assert (tmatch.numpy() >= 0).any()


@pytest.mark.parametrize("family", ["Cylinders", "Cuboids", "Ellipsoids"])
def test_objects_empty_matches_jax(family):
    """`empty(n)` of each family: the JAX package's arrays, field by field
    (values, dtypes, shapes), of the calling class, on the given device."""
    got = getattr(tobj, family).empty(5, device="cpu")
    want = getattr(jobj, family).empty(5)
    assert type(got).__name__ == family and got.capacity == 5
    assert got._fields == want._fields
    for f, a, b in zip(got._fields, got, want):
        assert a.device.type == "cpu", f
        assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype), f
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert not bool(got.valid.any())
    assert getattr(tobj, family).empty(3, dtype=torch.float64,
                                       device="cpu")[0].dtype == torch.float64


def test_pose_slot_matches_jax():
    """GraphState.pose_slot: robot * P + idx, as the JAX package's."""
    from _torch_parity import small_configs
    from slide_slam_tpu.factorgraph import graph as jgraph
    from slide_slam_tpu_torch.factorgraph import graph as tgraph
    jcfg, tcfg = small_configs()
    jcfg, tcfg = (c.replace(number_of_robots=3) for c in (jcfg, tcfg))
    js = jgraph.empty_state(jcfg)
    ts = tgraph.empty_state(tcfg, device="cpu")
    for robot, idx in ((0, 0), (1, 5), (2, 31)):
        assert ts.pose_slot(robot, idx) == int(js.pose_slot(robot, idx)) \
            == robot * 32 + idx
    slots = ts.pose_slot(torch.tensor([0, 2]), torch.tensor([3, 4]))
    assert slots.tolist() == [3, 68]
