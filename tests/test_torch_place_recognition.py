"""SlideMatch, CLIPPER and SlideGraph: the PyTorch port (on the CPU) against
the JAX package on the same numpy-seeded maps.

Mirrors tests/test_slidematch.py and tests/test_slidegraph.py. Tolerances:
* decisions and integers identical: found flags, inlier counts, fit pair
  counts, top-K candidate indices, CLIPPER inlier index sets, association
  pairs;
* transforms within 1e-3 (m, and rotation-matrix entries);
* the blocked CLIPPER ascent equals the early-exit loops bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_slam_tpu.config import PlaceRecognitionConfig as JPRC
from slide_slam_tpu.config import SlideGraphConfig as JSGC
from slide_slam_tpu.place_recognition import clipper as jcl
from slide_slam_tpu.place_recognition import slidegraph as jsg
from slide_slam_tpu.place_recognition import slidematch as jsm
from slide_slam_tpu_torch.config import PlaceRecognitionConfig as TPRC
from slide_slam_tpu_torch.config import SlideGraphConfig as TSGC
from slide_slam_tpu_torch.geometry import se3np
from slide_slam_tpu_torch.place_recognition import clipper as tcl
from slide_slam_tpu_torch.place_recognition import slidegraph as tsg
from slide_slam_tpu_torch.place_recognition import slidematch as tsm

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TF_TOL = 1e-3
DIMS = dict(fine_grid=512, disk_radius_cells=12, max_objects=256, n_yaw=24,
            rescore_topk=32)          # tests/test_slidematch.py TEST_DIMS


def random_objects(rng, n=60, extent=20.0, n_labels=3):
    objs = np.zeros((n, 7), np.float32)
    objs[:, 0] = rng.integers(0, n_labels, n)
    objs[:, 1:3] = rng.uniform(-extent, extent, (n, 2))
    objs[:, 3] = rng.uniform(0, 1, n)
    objs[:, 4] = rng.uniform(0.2, 0.6, n)
    return objs


def transform_objects(objs, x, y, yaw):
    out = objs.copy()
    c, s = np.cos(yaw), np.sin(yaw)
    px, py = objs[:, 1].copy(), objs[:, 2].copy()
    out[:, 1] = c * px - s * py + x
    out[:, 2] = s * px + c * py + y
    return out


def inverse_of(objs, x, y, yaw):
    """objs seen through the inverse of the SE(2) transform (x, y, yaw)."""
    tf_inv = np.linalg.inv(np.array([[np.cos(yaw), -np.sin(yaw), 0, x],
                                     [np.sin(yaw), np.cos(yaw), 0, y],
                                     [0, 0, 1, 0], [0, 0, 0, 1.0]]))
    return transform_objects(objs, tf_inv[0, 3], tf_inv[1, 3],
                             np.arctan2(tf_inv[1, 0], tf_inv[0, 0]))


def make_prs(**kw):
    args = dict(search_xy_step_size=kw.pop("step", 0.25),
                search_yaw_step_size_degrees=kw.pop("yaw_step", 15.0),
                match_threshold_position=kw.pop("thresh", 0.75),
                min_num_inliers=kw.pop("min_inliers", 8),
                min_num_map_objects_to_start=5, **kw)
    return (jsm.PlaceRecognition(JPRC(**args), jsm.SlideMatchDims(**DIMS)),
            tsm.PlaceRecognition(TPRC(**args), tsm.SlideMatchDims(**DIMS),
                                 device="cpu"))


# ---------------------------------------------------------------------------
# SlideMatch
# ---------------------------------------------------------------------------
def _case_inter(name):
    """(ref, qry, pr kwargs) of the tests/test_slidematch.py inter cases."""
    if name == "identity":
        ref = random_objects(np.random.default_rng(1), 60)
        return ref, ref.copy(), {}
    if name == "translation":
        ref = random_objects(np.random.default_rng(2), 60)
        return ref, transform_objects(ref, -6.0, 4.0, 0.0), {}
    if name == "rotation_noise_partial":
        rng = np.random.default_rng(3)
        ref = random_objects(rng, 80)
        subset = ref[rng.permutation(80)[:60]]
        qry = inverse_of(subset, 3.0, 5.0, np.deg2rad(45.0))
        qry[:, 1:3] += rng.normal(0, 0.05, (len(qry), 2))
        return ref, np.concatenate([qry, random_objects(rng, 10, 15.0)]), {}
    if name == "unrelated":
        return (random_objects(np.random.default_rng(4), 60),
                random_objects(np.random.default_rng(999), 60),
                dict(min_inliers=25))
    if name == "min_objects":
        ref = random_objects(np.random.default_rng(5), 3)
        return ref, ref, {}
    rng = np.random.default_rng(11)      # labels beyond 16 bins, and a decoy
    ref = random_objects(rng, n=70, extent=18.0, n_labels=1)
    ref[:, 0] = 17 + rng.integers(0, 10, len(ref))
    qry = inverse_of(ref, 5.0, -3.5, 0.5)
    qry = qry[rng.uniform(size=len(qry)) < 0.8]
    qry[:, 1:3] += rng.normal(0, 0.05, (len(qry), 2))
    if name == "labels_beyond_16":
        return ref, qry, {}
    decoy = qry.copy()
    decoy[:, 0] += 10
    return ref, decoy, {}


INTER_CASES = ["identity", "translation", "rotation_noise_partial",
               "unrelated", "min_objects", "labels_beyond_16",
               "labels_decoy"]


@pytest.mark.parametrize("name", INTER_CASES)
def test_slidematch_inter_matches_jax(name):
    """find_transformation(intra=False), the core of find_inter_loop_closure:
    found flag, inlier count and fit pair count identical, the TF within
    1e-3; the entry point's object-count gate on the small map."""
    ref, qry, kw = _case_inter(name)
    jpr, tpr = make_prs(**kw)
    if name == "min_objects":
        assert jpr.find_inter_loop_closure(ref, qry) == (False, None)
        assert tpr.find_inter_loop_closure(ref, qry) == (False, None)
        return
    j = jpr.find_transformation(ref, qry, intra=False)
    t = tpr.find_transformation(ref, qry, intra=False)
    assert t[0] == j[0] and t[3] == j[3]          # found, n_inliers
    assert t[4][0] == j[4][0]                     # fit pair count
    assert t[0] == (name not in ("unrelated", "labels_decoy"))
    if j[0]:
        np.testing.assert_allclose(t[2], j[2], atol=TF_TOL, rtol=0)
        np.testing.assert_allclose(t[4][1], j[4][1], atol=TF_TOL)


def test_slidematch_intra_matches_jax():
    """Body-frame measurements from a drifted pose (tests/test_slidematch.py
    test_intra_loop_closure_corrects_known_drift): the closure TF and fit."""
    rng = np.random.default_rng(6)
    world = random_objects(rng, 50, extent=10.0)
    true_pose = se3np.from_xyz_yaw(2.0, 1.0, 0.0, 0.3)
    drifted = se3np.compose(true_pose, se3np.from_xyz_yaw(1.2, -0.8, 0.0, 0.0))
    meas = world.copy()
    ph = np.concatenate([world[:, 1:4], np.ones((len(world), 1))], axis=1)
    meas[:, 1:4] = (se3np.matrix(se3np.inverse(true_pose)) @ ph.T).T[:, :3]
    cand = se3np.from_xyz_yaw(0.0, 0.0, 0.0, 0.0)
    jpr, tpr = make_prs(step=0.1, yaw_step=5.0, min_inliers=8)
    jf, jtf, jfit = jpr.find_intra_loop_closure(meas, world, drifted, cand)
    tf_, ttf, tfit = tpr.find_intra_loop_closure(meas, world, drifted, cand)
    assert jf and tf_
    assert tfit[0] == jfit[0]
    np.testing.assert_allclose(tfit[1], jfit[1], atol=TF_TOL)
    np.testing.assert_allclose(ttf, jtf, atol=TF_TOL, rtol=0)
    expect = np.linalg.inv(se3np.matrix(cand)) @ se3np.matrix(true_pose)
    np.testing.assert_allclose(ttf[:2, 3], expect[:2, 3], atol=0.15)


def test_topk_tie_order_matches_lax_top_k():
    """Forced ties: 24 x 64 x 64 counts from {-1, 0, 1, 2, 3}; the port's
    top-K indices equal lax.top_k's (equal counts: lower index first)."""
    rng = np.random.default_rng(0)
    counts = rng.integers(-1, 4, 24 * 64 * 64).astype(np.int32)
    for k in (1, 32, 64, 500):
        _, j_idx = jax.lax.top_k(jnp.asarray(counts), k)
        t_idx = tsm._topk_first_index(torch.as_tensor(counts), k)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


def test_raster_scores_on_a_tied_grid():
    """A square grid map matched against itself: many translations and
    yaws tie in the raster counts, so the candidate list depends on the
    top-K tie order. The packed kernel output (winner, inlier count, pair
    list) equals the JAX kernel's, and the unrounded FFT counts sit within
    0.01 of integers (the largest distance is printed)."""
    g = np.stack(np.meshgrid(np.arange(-4, 5) * 2.5, np.arange(-4, 5) * 2.5),
                 -1).reshape(-1, 2)
    objs = np.zeros((len(g), 7), np.float32)
    objs[:, 1:3] = g
    objs[:, 4] = 0.3
    dims_j = jsm.SlideMatchDims(**DIMS)
    dims_t = tsm.SlideMatchDims(**DIMS)
    M = DIMS["max_objects"]
    ref_p, ref_m = jsm._pad_objects(objs, M)
    bins = np.zeros((M,), np.int32)
    yaws = jsm._yaw_candidates(180.0, 15.0, False, DIMS["n_yaw"])
    args = (np.float32(12.0), np.float32(12.0), np.float32(0.25),
            np.float32(0.75), np.float32(5.0))
    j_out = np.asarray(jsm._slidematch_kernel(
        dims_j, ref_p, ref_m, ref_p, ref_m, jnp.asarray(bins),
        jnp.asarray(bins), jnp.asarray(yaws), *map(jnp.float32, args), True))
    tr, tm = tsm._pad_objects(objs, M, "cpu")
    f32 = [torch.tensor(a) for a in args]
    tb, ty = torch.as_tensor(bins), torch.as_tensor(yaws)
    t_out = tsm._slidematch_kernel(dims_t, tr, tm, tr, tm, tb, tb, ty,
                                   f32[0], f32[1], f32[3], f32[4],
                                   True).numpy()
    np.testing.assert_allclose(t_out[0, :3], j_out[0, :3], atol=1e-6)
    assert t_out[0, 3] == j_out[0, 3]
    np.testing.assert_array_equal(t_out[1:], j_out[1:])
    raw, _ = tsm.raster_counts(dims_t, tr, tm, tr, tm, tb, tb, ty, f32[0],
                               f32[1], f32[3])
    gap = float((raw - torch.round(raw)).abs().max())
    print(f"largest distance of an FFT count to its integer: {gap:.3e}")
    assert gap < 0.01


def test_slidematch_helpers_match_jax():
    np.testing.assert_array_equal(
        tsm._yaw_candidates(10.0, 15.0, False, 24),
        jsm._yaw_candidates(10.0, 15.0, False, 24))
    np.testing.assert_array_equal(
        tsm._yaw_candidates(180.0, 5.0, False, 24),
        jsm._yaw_candidates(180.0, 5.0, False, 24))
    for n in (0, 100, 384, 385, 1000):
        assert tsm._bucket_capacity(n, 384) == jsm._bucket_capacity(n, 384)
    rl = np.arange(40) * 3 % 23
    ql = np.arange(30) * 7 % 19 + 5
    for a, b in zip(tsm._compact_label_bins(rl, ql),
                    jsm._compact_label_bins(rl, ql)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    src = rng.normal(size=(20, 3))
    np.testing.assert_allclose(tsm.solve_lsq(src + 1.0, src),
                               jsm.solve_lsq(src + 1.0, src), atol=1e-12)


# ---------------------------------------------------------------------------
# CLIPPER
# ---------------------------------------------------------------------------
def _associations(seed, n_in, n_out):
    """Inlier pairs related by one rigid 2D transform, plus random outlier
    pairs (tests/test_slidegraph.py test_dense_clique_recovers_inliers)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-10, 10, (n_in, 2))
    yaw = 0.8
    R = np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]])
    pts2 = (R @ pts.T).T + np.array([3.0, -2.0])
    d1 = np.concatenate([pts, rng.uniform(-10, 10, (n_out, 2))])
    d2 = np.concatenate([pts2, rng.uniform(-10, 10, (n_out, 2))])
    return d1.astype(np.float32), d2.astype(np.float32)


def _early_exit_ascent(M, u0, p):
    """The JAX find_dense_clique's three nested while loops, one host read
    per condition: the specification the blocked form must equal."""
    A = tcl._Ascent(M, p)
    u, d = A.start(u0)
    F = torch.zeros((), dtype=M.dtype)
    i, done = 0, False
    while i < p.maxoliters and not done:
        g = A.grad(u, d, *A.products(u))
        F = torch.dot(u, g)
        j, stop = 0, False
        while j < p.maxiniters and not stop:
            k, alpha, unew, gnew, Fnew, ls_done = 0, 1.0, u, g, F, False
            while k < p.maxlsiters and not ls_done:
                cand = torch.clamp(u + alpha * g, min=0.0)
                cand = cand / torch.clamp(torch.linalg.norm(cand), min=1e-30)
                gc = A.grad(cand, d, *A.products(cand))
                Fc = torch.dot(cand, gc)
                if bool((Fc - F) < -p.eps):
                    alpha = alpha * p.beta
                else:
                    unew, gnew, Fnew, ls_done = cand, gc, Fc, True
                k += 1
            deltau = torch.linalg.norm(unew - u)
            stop = bool((deltau < p.tol_u) | (torch.abs(Fnew - F) < p.tol_F))
            u, g, F = unew, gnew, Fnew
            j += 1
        dd, cnt = A.deltad(u, *A.products(u))
        done = int(cnt) == 0
        if not done:
            d = d + dd
        i += 1
    return torch.cat([u, F[None], torch.round(F)[None]])


def _affinity(d1, d2, params, cap=None):
    m = len(d1)
    cap = cap or 1 << max(6, int(np.ceil(np.log2(m))))
    p1 = np.zeros((cap, 2), np.float32)
    p2 = np.zeros((cap, 2), np.float32)
    p1[:m], p2[:m] = d1, d2
    mask = np.arange(cap) < m
    u0 = np.zeros((cap,), np.float32)
    u0[:m] = np.random.default_rng(0).uniform(size=m).astype(np.float32)
    return p1, p2, mask, u0


@pytest.mark.parametrize("block", [1, 7, 32])
@pytest.mark.parametrize("limits", [None, (3, 5, 4)],
                         ids=["default", "capped"])
def test_blocked_ascent_equals_early_exit(monkeypatch, block, limits):
    """Every block size, with the default iteration limits and with small
    outer/inner/line-search caps that cut each loop: u, F and omega equal
    the early-exit loops' bit for bit."""
    params = tcl.ClipperParams(sigma=0.1, epsilon=0.3)
    if limits:
        params = params._replace(maxoliters=limits[0], maxiniters=limits[1],
                                 maxlsiters=limits[2])
    p1, p2, mask, u0 = _affinity(*_associations(0, 20, 15), params)
    M = tcl.affinity_matrix(torch.as_tensor(p1), torch.as_tensor(p2),
                            torch.as_tensor(mask), params)
    monkeypatch.setattr(tcl, "CLIPPER_BLOCK", block)
    got = tcl.find_dense_clique(M, torch.as_tensor(u0), params)
    want = _early_exit_ascent(M, torch.as_tensor(u0), params)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed,n_in,n_out", [(0, 20, 15), (1, 40, 60),
                                             (2, 120, 200)])
def test_clipper_matches_jax(seed, n_in, n_out):
    """Affinity within 1e-6; the ascent's support (u > 0), omega and the
    DSD_HEU inlier index set identical to the JAX package's. u itself
    agrees to 1e-3 only: F is flat across the clique's face, so where the
    ascent stops on it follows the f32 rounding of each step."""
    d1, d2 = _associations(seed, n_in, n_out)
    params = tcl.ClipperParams(sigma=0.1, epsilon=0.3)
    jparams = jcl.ClipperParams(sigma=0.1, epsilon=0.3)
    p1, p2, mask, u0 = _affinity(d1, d2, params)
    Mj = jcl.affinity_matrix(jnp.asarray(p1), jnp.asarray(p2),
                             jnp.asarray(mask), jparams)
    Mt = tcl.affinity_matrix(torch.as_tensor(p1), torch.as_tensor(p2),
                             torch.as_tensor(mask), params)
    np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), atol=1e-6)
    pj = np.asarray(jcl.find_dense_clique(Mj, jnp.asarray(u0), jparams))
    pt = tcl.find_dense_clique(Mt, torch.as_tensor(u0), params).numpy()
    np.testing.assert_array_equal(pt[:-2] > 0, pj[:-2] > 0)
    np.testing.assert_allclose(pt[:-2], pj[:-2], atol=1e-3)
    assert pt[-1] == pj[-1]
    ji = jcl.dense_clique_inliers(d1, d2, jparams)
    ti = tcl.dense_clique_inliers(d1, d2, params, device="cpu")
    np.testing.assert_array_equal(np.sort(ti), np.sort(ji))
    assert np.mean(ti < n_in) > 0.95 and len(ti) >= 0.8 * n_in


def test_clipper_dsd_rounding_raises():
    """DSD rounding no longer raises (clipper_alternates is ported): the
    inlier set equals the JAX package's, identical."""
    d1, d2 = _associations(0, 5, 3)
    got = tcl.dense_clique_inliers(d1, d2, tcl.ClipperParams(), device="cpu",
                                   rounding="dsd")
    want = jcl.dense_clique_inliers(d1, d2, jcl.ClipperParams(),
                                    rounding="dsd")
    np.testing.assert_array_equal(got, want)
    assert len(got) >= 3


# ---------------------------------------------------------------------------
# SlideGraph
# ---------------------------------------------------------------------------
def _random_map(rng, n=50, extent=20.0):
    m = np.zeros((n, 7), np.float32)
    m[:, 0] = rng.integers(0, 3, n)
    m[:, 1:3] = rng.uniform(-extent, extent, (n, 2))
    return m


def _apply_tf(objs, tf4):
    out = objs.copy()
    ph = np.concatenate([objs[:, 1:3], np.ones((len(objs), 1))], axis=1)
    out[:, 1:3] = (tf4[np.ix_([0, 1], [0, 1, 3])] @ ph.T).T
    return out


def test_triangle_votes_match_jax():
    """Delaunay triangles, descriptors and the vote-ranked association
    pairs are the same numpy in both packages: identical outputs."""
    rng = np.random.default_rng(1)
    a = rng.uniform(-10, 10, (40, 2))
    b = a + rng.normal(0, 0.01, a.shape)
    tm, sm = tsg._triangulate(a)
    td, sd = tsg._triangulate(b)
    jm, jsm_ = jsg._triangulate(a)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(sm, jsm_)
    for x, y in zip(tsg.vote_associations(tm, sm, td, sd, 0.1, 2048),
                    jsg.vote_associations(tm, sm, td, sd, 0.1, 2048)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(tsg.estimate_tf_2d(a, b),
                               jsg.estimate_tf_2d(a, b), atol=1e-12)


@pytest.mark.parametrize("case", ["aligned", "unrelated"])
def test_slidegraph_matches_jax(case):
    """End to end (tests/test_slidegraph.py): found flag identical, the TF
    within 1e-3 of the JAX package's and of the truth within 0.3 m."""
    if case == "aligned":
        rng = np.random.default_rng(3)
        ref = _random_map(rng, 60)
        yaw, x, y = np.deg2rad(30.0), 5.0, -3.0
        tf_fwd = np.eye(4)
        tf_fwd[:2, :2] = [[np.cos(yaw), -np.sin(yaw)],
                          [np.sin(yaw), np.cos(yaw)]]
        tf_fwd[0, 3], tf_fwd[1, 3] = x, y
        qry = _apply_tf(ref, np.linalg.inv(tf_fwd))
        qry[:, 1:3] += rng.normal(0, 0.02, (len(qry), 2))
        kw = dict(min_num_map_objects_to_start=10)
    else:
        ref = _random_map(np.random.default_rng(4), 50)
        qry = _random_map(np.random.default_rng(5), 50)
        kw = dict(min_num_map_objects_to_start=10, num_inliers_threshold=10)
    jf, jtf = jsg.SlideGraph(JSGC(**kw)).find_inter_loop_closure(ref, qry)
    tf_, ttf = tsg.SlideGraph(TSGC(**kw),
                              device="cpu").find_inter_loop_closure(ref, qry)
    assert tf_ == jf == (case == "aligned")
    if jf:
        np.testing.assert_allclose(ttf, jtf, atol=TF_TOL, rtol=0)
        assert abs(ttf[0, 3] - 5.0) < 0.3 and abs(ttf[1, 3] + 3.0) < 0.3
