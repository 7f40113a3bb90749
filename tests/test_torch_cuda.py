"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips with a reason where there is no card (a CUDA
kernel has no CPU mode). This file imports no JAX, so it also runs on a
machine that has PyTorch and a card but no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

DBSCAN labels must be EXACTLY equal (the kernel rounds every product and sum
as the plain version does and sweeps synchronously).
"""
import numpy as np
import pytest
import torch

from slide_slam_tpu_torch.frontend import clustering

from _dbscan_cases import CASES, trees


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
    before = clustering.dbscan_cuda.launches
    got = clustering.dbscan(p, v, eps, ms)
    assert clustering.dbscan_cuda.launches == before + 1
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
