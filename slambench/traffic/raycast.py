"""Dense LiDAR scans ray-cast over a spinning sensor's full beam grid.

Each scan is what an Ouster OS1-64 returns from a forest: one beam per
pixel of the rows x cols range image (vertical angles at the pixel centres
of [fov_down, fov_up], azimuths at the pixel centres of the full circle),
the nearest hit of each beam against the ground plane z = 0 and the finite
trunks and poles of the world (cylinders of the world's root, axis and
radius, `heights` tall), dropped where that hit lies beyond `range_m`,
with Gaussian range noise. Every returned point carries the class of the
object it hit, as the upstream inference node publishes a segmented cloud
(tree 8, lightpole 9, ground 1).

The beams sit at pixel centres, so the program's spherical projection puts
each returned point on its own pixel: a label image indexed by beam is the
segmentation of that scan, and no network runs.

Runs on the device it is given, in float64, from a torch.Generator seeded
from the run's seed; the same seed gives the same scans.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

GROUND = 1


class DenseScan(NamedTuple):
    points: np.ndarray        # [n, 3] float32, body frame, beam order
    labels: np.ndarray        # [n] int32 class of the hit object
    beam: np.ndarray          # [n] int64 row * cols + col of each point
    label_image: torch.Tensor  # [1, rows, cols] int32 on the device


def beam_directions(rows: int, cols: int, fov_up_deg: float,
                    fov_down_deg: float) -> np.ndarray:
    """[rows * cols, 3] unit body-frame directions, row-major: row 0 is the
    highest beam, column j looks along yaw = pi (2 (j + 0.5) / cols - 1) in
    the projection's convention (yaw = -atan2(y, x))."""
    up, down = math.radians(fov_up_deg), math.radians(fov_down_deg)
    fov = abs(up) + abs(down)
    pitch = up - (np.arange(rows) + 0.5) * fov / rows
    yaw = np.pi * (2.0 * (np.arange(cols) + 0.5) / cols - 1.0)
    p, y = np.meshgrid(pitch, yaw, indexing="ij")
    d = np.stack([np.cos(p) * np.cos(-y), np.cos(p) * np.sin(-y), np.sin(p)],
                 axis=-1)
    return d.reshape(-1, 3)


def _rotation(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)])])


def cast(world, poses: np.ndarray, sensor: dict, heights: dict,
         range_noise_m: float, seed: int, device) -> List[DenseScan]:
    """One DenseScan per true pose [K, 7] (sensor frame = body frame).
    `sensor`: rows, cols, fov_up_deg, fov_down_deg, range_m; `heights`:
    class id (str) -> trunk height in metres."""
    dev = torch.device(device)
    f64 = torch.float64
    rows, cols = int(sensor["rows"]), int(sensor["cols"])
    dirs_b = torch.as_tensor(beam_directions(
        rows, cols, sensor["fov_up_deg"], sensor["fov_down_deg"]),
        dtype=f64, device=dev)
    root = torch.as_tensor(world.cyl_root, dtype=f64, device=dev)
    axis = torch.as_tensor(world.cyl_ray, dtype=f64, device=dev)
    axis = axis / torch.linalg.norm(axis, dim=1, keepdim=True)
    radius = torch.as_tensor(world.cyl_radius, dtype=f64, device=dev)
    label = torch.as_tensor(world.cyl_label.astype(np.int64), device=dev)
    height = torch.as_tensor(
        [float(heights[str(int(c))]) for c in world.cyl_label], dtype=f64,
        device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2 ** 63))
    noise = torch.randn((len(poses), rows * cols), generator=gen,
                        device=dev, dtype=f64) * range_noise_m
    inf = torch.tensor(float("inf"), dtype=f64, device=dev)
    out = []
    for k, pose in enumerate(np.asarray(poses, np.float64)):
        pose_t = torch.as_tensor(pose, dtype=f64, device=dev)
        d = dirs_b @ _rotation(pose_t[:4]).T                # world directions
        o = pose_t[4:7]
        t_ground = torch.where(d[:, 2] < -1e-12, -o[2] / d[:, 2], inf)
        w = o[None, :] - root                               # [M, 3]
        wa = (w * axis).sum(1)                              # [M]
        da = d @ axis.T                                     # [B, M]
        wd = d @ w.T                                        # [B, M]
        a = 1.0 - da * da
        b = 2.0 * (wd - wa[None, :] * da)
        c = (w * w).sum(1) - wa * wa - radius * radius      # [M]
        disc = b * b - 4.0 * a * c[None, :]
        ok = (disc >= 0) & (a > 1e-12) & (c[None, :] > 0)
        t = (-b - torch.sqrt(torch.clamp(disc, min=0))) / (2.0 * torch.where(
            ok, a, torch.ones_like(a)))
        h = wa[None, :] + t * da
        ok = ok & (t > 0) & (h >= 0) & (h <= height[None, :])
        t = torch.where(ok, t, inf)
        t_cyl, which = t.min(dim=1)
        hit_cyl = t_cyl < t_ground
        t_hit = torch.minimum(t_cyl, t_ground)
        lab = torch.where(hit_cyl, label[which],
                          torch.full_like(which, GROUND))
        keep = t_hit <= float(sensor["range_m"])
        rng = t_hit + noise[k]
        pts = dirs_b * rng[:, None]
        image = torch.where(keep, lab, torch.zeros_like(lab)).to(torch.int32)
        idx = torch.nonzero(keep).squeeze(1)
        out.append(DenseScan(
            points=pts[idx].to(torch.float32).cpu().numpy(),
            labels=lab[idx].to(torch.int32).cpu().numpy(),
            beam=idx.cpu().numpy(),
            label_image=image.reshape(1, rows, cols)))
    return out
