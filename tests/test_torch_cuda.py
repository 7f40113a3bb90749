"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips with a reason where there is no card (a CUDA
kernel has no CPU mode). This file imports no JAX, so it also runs on a
machine that has PyTorch and a card but no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

DBSCAN labels must be EXACTLY equal (the kernel rounds every product and sum
as the plain version does and sweeps synchronously), for the one-set
one-stage call and for the batched two-stage call, which runs every set and
both stages in exactly one launch.
"""
import numpy as np
import pytest
import torch

from slide_slam_tpu_torch.frontend import clustering

from _dbscan_cases import CASES, slice_batch, stack, trees, two_stage_batch


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the DBSCAN kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dbscan_kernel_equals_plain(case):
    _card()
    _, (pts, valid), eps, ms = case
    p = torch.as_tensor(pts, device="cuda")
    v = torch.as_tensor(valid, device="cuda")
    before = clustering.launch_dbscan.launches
    got = clustering.dbscan(p, v, eps, ms)
    assert clustering.launch_dbscan.launches == before + 1
    ref = clustering.dbscan_reference(p, v, eps, ms)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_two_stage_cluster_card_equals_cpu():
    _card()
    pts, valid = trees(seed=3)
    args = (0.5, 5, 0.8, 8)
    got = clustering.two_stage_cluster(torch.as_tensor(pts, device="cuda"),
                                       torch.as_tensor(valid, device="cuda"),
                                       *args)
    ref = clustering.two_stage_cluster(torch.as_tensor(pts),
                                       torch.as_tensor(valid), *args)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


@pytest.mark.cuda
def test_dbscan_kernel_refuses_what_it_cannot_take():
    _card()
    with pytest.raises(ValueError):
        clustering.dbscan(torch.zeros(1025, 3, device="cuda"),
                          torch.ones(1025, dtype=torch.bool, device="cuda"),
                          0.5, 5)
    with pytest.raises(ValueError):
        clustering.dbscan(torch.zeros(8, 2, device="cuda"),
                          torch.ones(8, dtype=torch.bool, device="cuda"),
                          0.5, 5)
    with pytest.raises(ValueError):
        clustering.dbscan(torch.zeros(8, 3, device="cuda"),
                          torch.ones(7, dtype=torch.bool, device="cuda"),
                          0.5, 5)


BATCHES = {"cases": two_stage_batch(), "slice_2x1024": slice_batch()}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", list(BATCHES))
def test_batched_kernel_equals_plain(batch):
    _card()
    pts, valid, params = stack(BATCHES[batch])
    args = [torch.as_tensor(a, device="cuda") for a in (pts, valid, params)]
    before = clustering.launch_dbscan.launches
    got = clustering.two_stage_cluster_batch(*args)
    assert clustering.launch_dbscan.launches == before + 1
    ref = clustering.two_stage_cluster_reference(
        *(torch.as_tensor(a) for a in (pts, valid, params)))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and tuple(got.shape) == valid.shape
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
def test_batched_kernel_any_cluster_size(cluster):
    """The labels do not depend on how many CTAs share a set (0: the size
    the library picks for this card, 16 or 8)."""
    _card()
    pts, valid, params = stack(BATCHES["slice_2x1024"])
    args = [torch.as_tensor(a, device="cuda") for a in (pts, valid, params)]
    got = clustering.launch_dbscan(*args, cluster=cluster)
    assert clustering.auto_cluster_size() in (8, 16)
    ref = clustering.two_stage_cluster_reference(
        *(torch.as_tensor(a) for a in (pts, valid, params)))
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


@pytest.mark.cuda
def test_batched_kernel_refuses_what_it_cannot_take():
    _card()
    p = torch.zeros(2, 64, 3, device="cuda")
    v = torch.ones(2, 64, dtype=torch.bool, device="cuda")
    q = torch.zeros(2, 4, device="cuda")
    bad = [(p.double(), v, q), (p, v.int(), q), (p, v, q[:1]),
           (p.transpose(0, 1).contiguous().transpose(0, 1), v, q),
           (p, v[:, :32], q), (p.cpu(), v, q)]
    for args in bad:
        with pytest.raises(ValueError):
            clustering.launch_dbscan(*args)
    with pytest.raises(RuntimeError):
        clustering.launch_dbscan(p, v, q, cluster=3)
