"""DBSCAN: the port's plain PyTorch version vs the JAX function on the path
(clustering.dbscan) and vs the Pallas kernel in interpret mode, with EXACT
label equality. (The CUDA kernel vs the plain version on the card is
tests/test_torch_cuda.py.)

Cases: blobs; a full N = 1024 class; a chain longer than 64 hops (neither
version converges within its 64 sweeps, and the synchronous sweeps must
still agree); all points invalid; the (eps, min_samples) pairs of the
slice's four DBSCAN stages (tree and lightpole, noise and cluster; three
distinct pairs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_slam_tpu.frontend import clustering as jclust
from slide_slam_tpu.frontend.clustering_pallas import dbscan_pallas
from slide_slam_tpu_torch.frontend import clustering as tclust
from slide_slam_tpu_torch.frontend.pipeline import forest_classes

from _dbscan_cases import (CASES, SLICE_PARAMS, big_batch, chain,
                           kitti_dense_batch, stack, trees,
                           two_stage_batch)


def _jax(pts, valid, eps, ms):
    return np.asarray(jclust.dbscan(jnp.asarray(pts), jnp.asarray(valid),
                                    eps, ms))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_equals_jax_dbscan(case):
    _, (pts, valid), eps, ms = case
    got = tclust.dbscan(torch.as_tensor(pts), torch.as_tensor(valid), eps, ms)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax(pts, valid, eps, ms))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_equals_pallas_interpret(case):
    """The Pallas kernel (interpret mode) on inputs where its fixed 64
    sweeps and its |p|^2+|q|^2-2pq distances give the XLA labels."""
    _, (pts, valid), eps, ms = case
    got = tclust.dbscan(torch.as_tensor(pts), torch.as_tensor(valid), eps, ms)
    ref = np.asarray(dbscan_pallas(jnp.asarray(pts), jnp.asarray(valid),
                                   eps=eps, min_samples=ms, interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_chain_does_not_converge_in_64_sweeps():
    """The chain case really exercises the sweep cap: with more sweeps the
    labels change."""
    pts, valid = chain()
    t = torch.as_tensor(pts), torch.as_tensor(valid)
    capped = tclust.dbscan_reference(*t, 0.6, 2)
    full = tclust.dbscan_reference(*t, 0.6, 2, max_iters=512)
    assert not torch.equal(capped, full)
    assert int(full[:150].max()) == 0


def test_two_stage_matches_jax():
    pts, valid = trees(seed=2)
    spec = next(c for c in forest_classes() if c.name == "tree")
    args = (spec.eps_noise, spec.min_samples_noise, spec.eps_cluster,
            spec.min_samples_cluster)
    got = tclust.two_stage_cluster(torch.as_tensor(pts),
                                   torch.as_tensor(valid), *args)
    ref = jclust.two_stage_cluster(jnp.asarray(pts), jnp.asarray(valid), *args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrapper_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        tclust.dbscan_cuda(torch.zeros(8, 3), torch.ones(8, dtype=bool), 1.0, 2)
    with pytest.raises(ValueError):
        tclust.launch_dbscan(torch.zeros(1, 8, 3), torch.ones(1, 8, dtype=bool),
                             torch.zeros(1, 4))


BATCH = two_stage_batch()


@pytest.fixture(scope="module")
def batch_labels():
    pts, valid, params = stack(BATCH)
    before = tclust.launch_dbscan.launches
    got = tclust.two_stage_cluster_batch(torch.as_tensor(pts),
                                         torch.as_tensor(valid),
                                         torch.as_tensor(params))
    assert tclust.launch_dbscan.launches == before     # CPU: the plain version
    assert got.dtype == torch.int32 and tuple(got.shape) == valid.shape
    return got.numpy()


@pytest.mark.parametrize("c", range(len(BATCH)), ids=[b[0] for b in BATCH])
def test_batched_plain_equals_jax_two_stage(batch_labels, c):
    """Each set of one batched two-stage call equals the JAX
    two_stage_cluster on that set alone, label for label."""
    _, (pts, valid), args = BATCH[c]
    ref = jclust.two_stage_cluster(jnp.asarray(pts), jnp.asarray(valid), *args)
    np.testing.assert_array_equal(batch_labels[c], np.asarray(ref))


def test_batch_cases_are_what_they_claim(batch_labels):
    names = [b[0] for b in BATCH]
    valid = {b[0]: b[1][1] for b in BATCH}
    assert valid["lightpole_176"].sum() == 176
    v = valid["scattered_valid"]
    assert not np.array_equal(v, np.arange(len(v)) < v.sum())   # not a prefix
    assert {tuple(b[2][:2]) for b in BATCH} | {tuple(b[2][2:]) for b in BATCH} \
        >= set(SLICE_PARAMS)
    for c, name in enumerate(names):                 # every set has clusters
        assert (batch_labels[c] >= 0).any(), name


@pytest.mark.parametrize("n", [1500, 4096])
def test_batched_plain_above_1024_equals_jax_two_stage(n):
    """Above 1024 points per set (the kernel's global-memory path): the
    plain twin's batched call against the JAX two_stage_cluster, set by
    set, label for label; at 1500 the big cases (dense trunks, one blob
    that is a single cluster, a chain of the whole set, scattered valid
    flags, no valid point), at 4096 the KITTI preset's dense scan."""
    batch = big_batch(n) if n == 1500 else kitti_dense_batch(n)
    pts, valid, params = stack(batch)
    got = tclust.two_stage_cluster_batch(torch.as_tensor(pts),
                                         torch.as_tensor(valid),
                                         torch.as_tensor(params)).numpy()
    for c, (name, (p, v), args) in enumerate(batch):
        ref = jclust.two_stage_cluster(jnp.asarray(p), jnp.asarray(v), *args)
        np.testing.assert_array_equal(got[c], np.asarray(ref), err_msg=name)
    assert (got >= 0).any(axis=1).sum() >= 2
