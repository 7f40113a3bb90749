"""Batched cylinder (tree/pole) fitting (PyTorch twin of
slide_slam_tpu/frontend/cylinder_fit.py).

* local ground-patch plane per instance: batched-hypothesis RANSAC with a
  masked least-squares refit of the winning consensus set;
* axis = principal direction of the instance points, oriented along the
  ground normal;
* radius from the largest pairwise distance in the breast-height band,
  clamped to the radius cutoff with a default fallback;
* root = the axis through the band centroid intersected with the ground.

The JAX RANSAC draws its triples with `jax.random`, whose bits PyTorch
cannot reproduce: `fit_plane_ransac` takes the raw draws as an optional
`draws` argument, and otherwise draws them from a `torch.Generator` seeded
with `seed`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_INT32_MAX = 2 ** 31 - 1


class CylinderFit(NamedTuple):
    root: torch.Tensor     # [I, 3]
    ray: torch.Tensor      # [I, 3] unit, upward
    radius: torch.Tensor   # [I]
    valid: torch.Tensor    # [I]


def _masked_mean_cov(points, mask):
    """Per-row masked mean [I, 3] and covariance [I, 3, 3]."""
    c = torch.clamp(mask.sum(dim=-1), min=1).to(points.dtype)
    mu = torch.where(mask[..., None], points, 0.0).sum(dim=-2) / c[:, None]
    d = torch.where(mask[..., None], points - mu[:, None, :], 0.0)
    return mu, d.transpose(-1, -2) @ d / c[:, None, None]


def _lsq_plane(points, mask):
    """Masked least-squares plane per row: (unit upward normal, d)."""
    mu, cov = _masked_mean_cov(points, mask)
    _, v = torch.linalg.eigh(cov)
    nrm = v[..., :, 0]
    nrm = torch.where(nrm[:, 2:3] < 0, -nrm, nrm)
    return nrm, -(nrm * mu).sum(dim=-1)


def fit_plane_lsq(points: torch.Tensor, mask: torch.Tensor,
                  robust_thresh: float = 0.1):
    """Masked plane fit per batch row: points [I, G, 3], mask [I, G] ->
    (normal [I, 3] unit and upward, d [I]) with n.x + d = 0, after one
    robust re-fit on the points within `robust_thresh` of the first plane
    (kept only where >= 3 of them remain)."""
    nrm, d = _lsq_plane(points, mask)
    dist = torch.abs((points * nrm[:, None, :]).sum(dim=-1) + d[:, None])
    m2 = mask & (dist < robust_thresh)
    m2 = torch.where((m2.sum(dim=-1) >= 3)[:, None], m2, mask)
    return _lsq_plane(points, m2)


def ransac_draws(n_rows: int, n_hypotheses: int, seed: int = 0,
                 device="cpu") -> torch.Tensor:
    """[I, H, 3] int64 uniform draws in [0, 2^31 - 1), from a CPU
    torch.Generator seeded with `seed` and then moved to `device`, so the
    card and the CPU fit the same hypotheses."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, _INT32_MAX, (n_rows, n_hypotheses, 3),
                         generator=g).to(device)


def fit_plane_ransac(points: torch.Tensor, mask: torch.Tensor,
                     thresh: float = 0.1, n_hypotheses: int = 64,
                     seed: int = 0, draws: Optional[torch.Tensor] = None):
    """Batched RANSAC plane fit: points [I, G, 3], mask [I, G] ->
    (normal [I,3] unit upward, d [I], inlier_count [I]).

    All hypotheses at once: [I, H] planes from point triples drawn from the
    masked subset of each row, [I, H, G] inlier tests, the first best count,
    then a masked least-squares refit of the winning consensus set (or a
    robust refit of the whole mask when no hypothesis survives).
    `draws` [I, H, 3] non-negative ints replace the generator's draws."""
    I, G, _ = points.shape
    dev = points.device
    if draws is None:
        draws = ransac_draws(I, n_hypotheses, seed, dev)
    r = torch.as_tensor(draws, device=dev).long()
    order = torch.sort(torch.where(mask, 0, 1), dim=-1, stable=True).indices
    n_valid = mask.sum(dim=-1)
    cnt = torch.clamp(n_valid, min=1)[:, None]
    j0 = r[..., 0] % cnt
    j1 = (r[..., 1] % cnt + 1 + j0) % cnt
    j2 = (r[..., 2] % cnt + 7 + j1) % cnt
    j = torch.stack([j0, j1, j2], dim=-1)                       # [I, H, 3]
    idx = torch.gather(order, 1, j.reshape(I, -1)).reshape(j.shape)
    tri = torch.gather(points, 1, idx.reshape(I, -1, 1).expand(-1, -1, 3)
                       ).reshape(I, -1, 3, 3)                     # [I, H, 3, 3]
    tri_ok = torch.gather(mask, 1, idx.reshape(I, -1)).reshape(j.shape).all(-1)
    tri_ok = tri_ok & (n_valid >= 3)[:, None]
    p0, p1, p2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    nn = torch.linalg.norm(n, dim=-1, keepdim=True)
    degenerate = nn[..., 0] < 1e-9
    n = n / torch.clamp(nn, min=1e-9)
    n = n * torch.where(n[..., 2:3] < 0, -1.0, 1.0)
    d = -(n * p0).sum(dim=-1)                                    # [I, H]
    dist = torch.abs(torch.einsum("ihd,igd->ihg", n, points) + d[..., None])
    inl = (dist < thresh) & mask[:, None, :]
    counts = torch.where(tri_ok & ~degenerate, inl.sum(dim=-1), -1)
    best = torch.argmax(counts, dim=-1)                          # first max
    best_inl = inl[torch.arange(I, device=dev), best]
    best_cnt = counts[torch.arange(I, device=dev), best]

    n0, d0 = _lsq_plane(points, mask)
    fb_inl = mask & (torch.abs(torch.einsum("igd,id->ig", points, n0)
                               + d0[:, None]) < thresh)
    fb = torch.where((fb_inl.sum(dim=-1) >= 3)[:, None], fb_inl, mask)
    refit = torch.where((best_cnt >= 3)[:, None], best_inl, fb)
    nf, df = _lsq_plane(points, refit)
    return nf, df, torch.clamp(best_cnt, min=0)


def fit_cylinders(points: torch.Tensor, mask: torch.Tensor,
                  ground_normal: torch.Tensor, ground_d: torch.Tensor,
                  *, breast_height: float = 1.37, band_half: float = 0.3,
                  radius_cutoff=(0.05, 1.0), default_radius: float = 0.2,
                  min_points: int = 10, min_band_points: int = 3
                  ) -> CylinderFit:
    """points [I, P, 3] instance clouds (world), mask [I, P], per-instance
    ground plane (normal [I,3], d [I])."""
    cnt = mask.sum(dim=-1)
    _, cov = _masked_mean_cov(points, mask)
    axis = torch.linalg.eigh(cov)[1][..., :, -1]                 # [I, 3]
    updot = (axis * ground_normal).sum(dim=-1)
    axis = axis * torch.where(updot < 0, -1.0, 1.0)[:, None]
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True),
                              min=1e-9)

    h = torch.einsum("ipd,id->ip", points, ground_normal) + ground_d[:, None]
    band = mask & (torch.abs(h - breast_height) < band_half)
    band_cnt = band.sum(dim=-1)

    dd = points[:, :, None, :] - points[:, None, :, :]
    d2 = (dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]) + dd[..., 2] * dd[..., 2]
    d2 = torch.where(band[:, :, None] & band[:, None, :], d2, 0.0)
    diameter = torch.sqrt(d2.amax(dim=(1, 2)))
    lo, hi = 2 * radius_cutoff[0], 2 * radius_cutoff[1]
    radius = torch.where((diameter < lo) | (diameter > hi),
                         torch.full_like(diameter, default_radius),
                         0.5 * diameter)

    bc = torch.clamp(band_cnt, min=1).to(points.dtype)[:, None]
    rep = torch.where(band[..., None], points, 0.0).sum(dim=1) / bc
    denom = (ground_normal * axis).sum(dim=-1)
    t = -((ground_normal * rep).sum(dim=-1) + ground_d) / torch.where(
        torch.abs(denom) < 1e-6, torch.full_like(denom, 1e-6), denom)
    root = rep + t[:, None] * axis
    ok = (cnt >= min_points) & (band_cnt >= min_band_points)
    return CylinderFit(root=root, ray=axis, radius=radius, valid=ok)


def select_ground_patches(ground_points: torch.Tensor,
                          ground_valid: torch.Tensor, centroids: torch.Tensor,
                          patch_size: float) -> torch.Tensor:
    """[I, G] masks of ground points within patch_size/2 (XY) of each
    instance centroid."""
    dxy = torch.linalg.norm(ground_points[None, :, :2] - centroids[:, None, :2],
                            dim=-1)
    return ground_valid[None, :] & (dxy < patch_size / 2)
