"""The port's CLIPPER alternates (place_recognition/clipper_alternates.py)
and CLIPPER's DSD rounding (clipper.dense_clique_inliers(rounding="dsd"))
against the JAX package on the CPU: the ten cases of
tests/test_clipper_alternates.py, each also run through the JAX package.

Tolerances: clique and densest-subgraph node sets identical (the same C++
search, or the same Python fallback), densities within 1e-9; the SDR's node
sets identical and its spectraplex projection within 1e-5 of the JAX one
(eigenvector signs and the order of equal eigenvalues may differ between
the two eigh builds, so vectors are not compared); inlier sets of the DSD
rounding identical.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_slam_tpu.place_recognition import clipper as jcl
from slide_slam_tpu.place_recognition import clipper_alternates as jalt
from slide_slam_tpu_torch import native
from slide_slam_tpu_torch.place_recognition import clipper as cl
from slide_slam_tpu_torch.place_recognition import clipper_alternates as alt

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _random_graph(rng, n, p):
    A = rng.uniform(size=(n, n)) < p
    A = np.triu(A, 1)
    return (A | A.T).astype(np.uint8)


def _brute_max_clique_size(A):
    n = A.shape[0]
    for k in range(n, 0, -1):
        for comb in itertools.combinations(range(n), k):
            if np.all(A[np.ix_(comb, comb)] + np.eye(k) > 0):
                return k
    return 0


def _is_clique(A, nodes):
    return np.all(A[np.ix_(nodes, nodes)] + np.eye(len(nodes)) > 0)


def test_max_clique_exact_matches_bruteforce_and_jax():
    rng = np.random.default_rng(0)
    for n, p in [(8, 0.4), (10, 0.5), (12, 0.6), (14, 0.3)]:
        A = _random_graph(rng, n, p)
        clique = alt.max_clique(A, method="exact")
        assert _is_clique(A, clique)
        assert len(clique) == _brute_max_clique_size(A)
        np.testing.assert_array_equal(clique, jalt.max_clique(A))
        np.testing.assert_array_equal(alt._py_max_clique(A),
                                      jalt._py_max_clique(A))


def test_max_clique_planted():
    rng = np.random.default_rng(1)
    n, k = 40, 9
    A = _random_graph(rng, n, 0.15)
    planted = rng.choice(n, size=k, replace=False)
    for i, j in itertools.combinations(planted, 2):
        A[i, j] = A[j, i] = 1
    clique = alt.max_clique(A, method="exact")
    assert set(planted) <= set(clique.tolist()) or len(clique) >= k
    np.testing.assert_array_equal(clique, jalt.max_clique(A))


def test_max_clique_heu_and_kcore():
    if not native.available():
        pytest.skip("no g++: the native heuristics cannot be built here")
    rng = np.random.default_rng(2)
    n, k = 30, 8
    A = _random_graph(rng, n, 0.1)
    planted = rng.choice(n, size=k, replace=False)
    for i, j in itertools.combinations(planted, 2):
        A[i, j] = A[j, i] = 1
    heu = native.max_clique(A, method="heu")
    assert _is_clique(A, heu) and len(heu) >= k - 1
    kcore = native.max_clique(A, method="kcore")
    assert set(planted.tolist()) <= set(kcore.tolist())
    for method, got in (("heu", heu), ("kcore", kcore)):
        np.testing.assert_array_equal(got, jalt.max_clique(A, method=method))


def test_densest_subgraph_matches_bruteforce_and_jax():
    rng = np.random.default_rng(3)
    for n in [6, 8, 10]:
        W = rng.uniform(size=(n, n)) * (rng.uniform(size=(n, n)) < 0.5)
        W = np.triu(W, 1)
        W = W + W.T
        nodes, density = alt.densest_subgraph(W)
        ref_nodes, ref_density = alt._py_densest_subgraph(W)
        assert density == pytest.approx(ref_density, abs=1e-6)
        got = np.triu(W[np.ix_(nodes, nodes)], 1).sum() / max(len(nodes), 1)
        assert got == pytest.approx(density, abs=1e-9)
        j_nodes, j_density = jalt.densest_subgraph(W)
        np.testing.assert_array_equal(nodes, j_nodes)
        assert density == pytest.approx(j_density, abs=1e-9)
        np.testing.assert_array_equal(ref_nodes,
                                      jalt._py_densest_subgraph(W)[0])


def test_densest_subgraph_planted_clique():
    rng = np.random.default_rng(4)
    n, k = 60, 12
    W = np.maximum(np.zeros((n, n)), _random_graph(rng, n, 0.05) * 0.3)
    planted = np.arange(10, 10 + k)
    for i, j in itertools.combinations(planted, 2):
        W[i, j] = W[j, i] = 1.0
    nodes, density = alt.densest_subgraph(W)
    assert set(planted.tolist()) <= set(nodes.tolist())
    assert density >= (k - 1) / 2 - 1e-6
    np.testing.assert_array_equal(nodes, jalt.densest_subgraph(W)[0])


def test_densest_subgraph_subset_restriction():
    n = 10
    W = np.zeros((n, n))
    for i, j in itertools.combinations(range(4), 2):
        W[i, j] = W[j, i] = 1.0
    for i, j in itertools.combinations(range(5, 9), 2):
        W[i, j] = W[j, i] = 1.0
    nodes, _ = alt.densest_subgraph(W, subset=np.arange(5, 10))
    assert set(nodes.tolist()) == {5, 6, 7, 8}
    np.testing.assert_array_equal(
        nodes, jalt.densest_subgraph(W, subset=np.arange(5, 10))[0])


def _planted_problem(rng, n_in=15, n_out=10):
    pts = rng.uniform(-10, 10, (n_in, 2))
    yaw = 0.7
    R = np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]])
    pts2 = (R @ pts.T).T + np.array([2.0, -1.0])
    d1 = np.concatenate([pts, rng.uniform(-10, 10, (n_out, 2))])
    d2 = np.concatenate([pts2, rng.uniform(-10, 10, (n_out, 2))])
    return d1, d2, n_in


def _params():
    return (cl.ClipperParams(sigma=0.1, epsilon=0.3),
            jcl.ClipperParams(sigma=0.1, epsilon=0.3))


def test_solve_as_maximum_clique_recovers_inliers():
    d1, d2, n_in = _planted_problem(np.random.default_rng(5))
    tp, jp = _params()
    inliers = alt.solve_as_maximum_clique(d1, d2, tp, device="cpu")
    assert len(inliers) >= n_in * 0.8
    assert np.mean(inliers < n_in) > 0.95
    np.testing.assert_array_equal(inliers,
                                  jalt.solve_as_maximum_clique(d1, d2, jp))


def test_solve_as_msrc_sdr_recovers_inliers():
    d1, d2, n_in = _planted_problem(np.random.default_rng(6))
    tp, jp = _params()
    inliers = alt.solve_as_msrc_sdr(d1, d2, tp, device="cpu")
    assert len(inliers) >= n_in * 0.7
    assert np.mean(inliers < n_in) > 0.9
    np.testing.assert_array_equal(inliers, jalt.solve_as_msrc_sdr(d1, d2, jp))


def test_dsd_rounding_mode():
    """clipper.dense_clique_inliers(rounding="dsd") against the JAX
    package's: the same inlier set, and a subset of the nonzero support."""
    d1, d2, n_in = _planted_problem(np.random.default_rng(7))
    tp, jp = _params()
    inliers = cl.dense_clique_inliers(d1, d2, tp, rounding="dsd",
                                      device="cpu")
    assert len(inliers) >= n_in * 0.8
    assert np.mean(inliers < n_in) > 0.95
    nz = cl.dense_clique_inliers(d1, d2, tp, rounding="nonzero", device="cpu")
    assert set(inliers.tolist()) <= set(nz.tolist())
    np.testing.assert_array_equal(
        inliers, jcl.dense_clique_inliers(d1, d2, jp, rounding="dsd"))


def test_sdr_spectraplex_projection():
    rng = np.random.default_rng(8)
    Y = rng.normal(size=(12, 12)).astype(np.float32)
    X = alt._project_spectraplex(torch.as_tensor(Y)).numpy()
    assert np.linalg.eigvalsh(X).min() >= -1e-5
    assert np.trace(X) == pytest.approx(1.0, abs=1e-4)
    X2 = alt._project_spectraplex(torch.as_tensor(X)).numpy()
    assert np.allclose(X, X2, atol=1e-4)
    np.testing.assert_allclose(
        X, np.asarray(jalt._project_spectraplex(jnp.asarray(Y))), atol=1e-5)
